"""ctypes binding and wrappers of the towers' fused convolutions: V1, the
low-channel convolution (``conv.cu``), and V2, the implicit GEMM
(``conv_gemm.cu``).

``conv_leaky(x, w, b, stride)`` is ``leaky_relu(conv2d(x, w, b, stride,
(k - 1) // 2), LEAK)`` in float32 for the layer shapes in ``SHAPES``, the
one table that maps each ``(c_in, c_out, k, stride)`` to its kernel: V1
takes block 4's ``conv0`` and ``conv1`` and block 3's ``conv0``, V2 every
other layer of blocks 2-4 (and block 1's ``conv2``, which has block 2's
``conv2``'s shape). On a CUDA tensor it is one launch of the shape's
kernel, counted in ``launch_counts[kernel.name]``; on a CPU tensor the
kernel's plain version, its arithmetic in plain PyTorch. ``takes`` is the
towers' dispatch: a layer goes to a kernel only on the card, in float32,
with autograd off, at a shape in ``SHAPES``. Each library is built with
nvcc at first use (``build.py``), never at import, so this module imports
on a machine without CUDA.
"""

from __future__ import annotations

import ctypes
import functools
import os
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from cuahn_vio_torch.ops.cuda import build, launch_counts

HERE = os.path.dirname(os.path.abspath(__file__))
LEAK = 0.1  # the towers' LeakyReLU slope, model_to_trace.py:12 (kLeak in both sources)
_P, _I = ctypes.c_void_p, ctypes.c_int


def out_size(n: int, k: int, stride: int) -> int:
    return (n + 2 * ((k - 1) // 2) - k) // stride + 1


def rounding_bound(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   stride: int) -> torch.Tensor:
    """Per output, how far two float32 evaluations of a kernel's function
    may lie apart: each sums the bias and n = c_in k^2 products, in
    whatever order, within (n + 2) u of the exact value relative to the sum
    of the terms' magnitudes (u = 2^-24; a rounding a product and one an
    add, or one an fma, and the LeakyReLU's product), so two lie within
    twice that."""
    n = w.shape[1] * w.shape[2] * w.shape[3]
    mag = F.conv2d(x.abs(), w.abs(), b.abs(), stride, (w.shape[2] - 1) // 2)
    return 2 * (n + 2) * 2.0 ** -24 * mag


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int,
           kernel: Optional["Kernel"] = None) -> tuple:
    """Shapes and dtypes that a kernel and its plain version take (``kernel``,
    or whichever ``SHAPES`` gives); returns (the shape key, the kernel)."""
    if x.dim() != 4 or w.dim() != 4 or b.dim() != 1:
        raise ValueError(f"want x (B, C, H, W), w (O, C, k, k), b (O,); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(b.shape)}")
    c_out, c_in, k, k2 = w.shape
    key = (c_in, c_out, k, stride)
    found = SHAPES.get(key)
    kernel = kernel or found
    if (found is None or found is not kernel or k != k2 or x.shape[1] != c_in
            or b.shape[0] != c_out):
        taken = sorted(s for s, kern in SHAPES.items() if kernel in (None, kern))
        raise ValueError(f"{kernel.label if kernel else 'V1 or V2'} takes (c_in, c_out, k, "
                         f"stride) in {taken}; got x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}, stride {stride}")
    if not all(t.dtype == torch.float32 for t in (x, w, b)):
        raise ValueError(f"{kernel.label} takes float32; got {x.dtype}, {w.dtype}, {b.dtype}")
    return key, kernel


def lowc_conv_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    stride: int) -> torch.Tensor:
    """V1's arithmetic in plain PyTorch: each output starts at its bias and
    takes the products in (c_in, ky, kx) order over the zero-padded input,
    then the LeakyReLU. The kernel rounds each product-and-add once (an
    fma), this version twice, so the two differ by rounding alone."""
    (c_in, c_out, k, s), _ = _check(x, w, b, stride, V1)
    pad = (k - 1) // 2
    oh, ow = out_size(x.shape[2], k, s), out_size(x.shape[3], k, s)
    xp = F.pad(x, (pad, pad, pad, pad))
    acc = b[None, :, None, None].expand(x.shape[0], c_out, oh, ow).clone()
    for ci in range(c_in):
        for ky in range(k):
            for kx in range(k):
                tap = xp[:, ci:ci + 1, ky:ky + s * (oh - 1) + 1:s, kx:kx + s * (ow - 1) + 1:s]
                acc += tap * w[None, :, ci, ky, kx, None, None]
    return F.leaky_relu(acc, LEAK)


def conv_gemm_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    stride: int) -> torch.Tensor:
    """V2's function in plain PyTorch, as the same GEMM: the zero-padded
    input unfolded to (B, C_in k^2, oh ow) in (c_in, ky, kx) order, the
    filter as (C_out, C_in k^2), their product plus the bias, then the
    LeakyReLU. The product sums in the library's order, not the kernel's,
    so the two differ by rounding alone (``rounding_bound``)."""
    (c_in, c_out, k, s), _ = _check(x, w, b, stride, V2)
    oh, ow = out_size(x.shape[2], k, s), out_size(x.shape[3], k, s)
    cols = F.unfold(x, k, padding=(k - 1) // 2, stride=s)
    acc = torch.matmul(w.reshape(c_out, -1), cols) + b[:, None]
    return F.leaky_relu(acc.reshape(x.shape[0], c_out, oh, ow), LEAK)


@dataclass(frozen=True, eq=False)  # each kernel is one object: hashed and compared by identity
class Kernel:
    """One of the towers' convolution kernels and what its launches need."""

    label: str  # its name in the docs: V1, V2
    name: str  # its ``launch_counts`` key
    symbol: str  # its ``__global__`` function, as ptxas and a trace name it
    source: str  # its CUDA source
    entry: str  # its C launcher: (x, w, bias, out, b, c_in, c_out, k, stride, h, w, oh, ow, stream)
    init: Optional[str]  # a C function run once when the library loads, before any launch
    plain: Callable  # its arithmetic in plain PyTorch, (x, w, b, stride) -> out
    fits: Callable  # (batch, c_in, h, w, oh, ow) -> whether its grid and indexing hold them


V1 = Kernel("V1", "lowc_conv", "lowc_conv_kernel", os.path.join(HERE, "conv.cu"),
            "lowc_conv_f32", None, lowc_conv_plain,
            lambda bsz, c_in, h, w, oh, ow: 0 < bsz <= 65535)
V2 = Kernel("V2", "conv_gemm", "gemm_conv_kernel", os.path.join(HERE, "conv_gemm.cu"),
            "conv_gemm_f32", "conv_gemm_init", conv_gemm_plain,
            lambda bsz, c_in, h, w, oh, ow: (0 < bsz and bsz * oh * ow < 2 ** 31 - 256
                                             and c_in * h * w < 2 ** 31))
KERNELS = (V1, V2)
SHAPES = {  # (c_in, c_out, k, stride) -> its kernel
    (2, 8, 7, 1): V1,  # block 4 conv0
    (8, 16, 5, 2): V1,  # block 4 conv1
    (2, 16, 7, 1): V1,  # block 3 conv0
    (2, 64, 7, 2): V2,  # block 2 conv0
    (64, 128, 5, 2): V2,  # block 2 conv1
    (16, 32, 5, 2): V2,  # block 3 conv1
    (16, 32, 3, 2): V2,  # block 4 conv2
    (32, 64, 3, 2): V2,  # block 3 conv2, block 4 conv3
    (64, 128, 3, 2): V2,  # block 3 conv3, block 4 conv4
    (128, 256, 3, 2): V2,  # block 2 conv2, block 3 conv4, block 4 conv5 (and block 1 conv2)
    (256, 256, 3, 2): V2,  # block 2 conv3, block 3 conv5, block 4 conv6
}


@functools.lru_cache(maxsize=None)
def _launcher(kernel: Kernel):
    """The kernel's C launcher, its library loaded and its ``init`` run."""
    if kernel.init is not None:
        err = build.entry(kernel.source, kernel.init, ())()  # e.g. each shape's shared memory,
        if err != 0:  # before any launch or capture
            raise RuntimeError(f"{kernel.name}: {kernel.init} failed: cudaError {err}")
    return build.entry(kernel.source, kernel.entry, (_P,) * 4 + (_I,) * 9 + (_P,))


def build_kernel() -> float:
    """Build both libraries now; returns the compile seconds (0.0 if they
    were already built). Loading them needs a card, so it is left to the
    first launch."""
    return sum(build.build(kernel.source)[1] for kernel in KERNELS)


def ptxas_report() -> dict:
    """ptxas's registers, shared memory and spills of each kernel of both
    libraries (``build.ptxas_report``)."""
    return {name: info for kernel in KERNELS
            for name, info in build.ptxas_report(build.library_path(kernel.source)).items()}


def takes(device: torch.device, dtype: torch.dtype, conv: torch.nn.Conv2d) -> bool:
    """Whether a tower runs ``conv`` on an input of ``device`` and ``dtype``
    through its kernel: on a CUDA device, in float32, while autograd
    records nothing, at a shape in ``SHAPES`` (padding (k - 1) // 2, as the
    towers build every layer). Every other layer and call keeps cuDNN's (or
    the CPU's) ``conv2d`` and a separate ``leaky_relu``."""
    k = conv.kernel_size[0]
    return (device.type == "cuda" and dtype == torch.float32 and not torch.is_grad_enabled()
            and (conv.in_channels, conv.out_channels, k, conv.stride[0]) in SHAPES
            and conv.padding[0] == (k - 1) // 2)


def conv_leaky_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    stride: int) -> torch.Tensor:
    """One launch of the shape's kernel on contiguous float32 CUDA tensors
    (B, c_in, H, W), (c_out, c_in, k, k) and (c_out,) -> (B, c_out, oh,
    ow); raises on anything the kernel does not take and on a failed
    launch."""
    (c_in, c_out, k, s), kernel = _check(x, w, b, stride)
    if not all(t.is_cuda for t in (x, w, b)) or len({x.device, w.device, b.device}) != 1:
        raise ValueError(f"{kernel.label} takes CUDA tensors on one device")
    if not all(t.is_contiguous() for t in (x, w, b)):
        raise ValueError(f"{kernel.label} takes contiguous tensors")
    bsz, _, h, wd = x.shape
    oh, ow = out_size(h, k, s), out_size(wd, k, s)
    if not kernel.fits(bsz, c_in, h, wd, oh, ow):
        raise ValueError(f"batch {bsz} of {tuple(x.shape[1:])} outside {kernel.label}'s grid "
                         f"or indexing")
    out = torch.empty((bsz, c_out, oh, ow), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launcher(kernel)(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                bsz, c_in, c_out, k, s, h, wd, oh, ow, stream)
    if err != 0:
        raise RuntimeError(f"{kernel.name} kernel launch failed: cudaError {err}")
    launch_counts[kernel.name] += 1
    return out


def conv_leaky(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """The shape's kernel on a CUDA tensor (``conv_leaky_cuda``), its plain
    version on a CPU one."""
    if x.is_cuda:
        return conv_leaky_cuda(x, w, b, stride)
    return _check(x, w, b, stride)[1].plain(x, w, b, stride)
