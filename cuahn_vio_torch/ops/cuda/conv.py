"""ctypes binding and wrappers of the towers' fused convolutions: V1, the
low-channel convolution (``conv.cu``), and V2, the implicit GEMM
(``conv_gemm.cu``), with its split path V2K.

``conv_leaky(x, w, b, stride)`` is ``leaky_relu(conv2d(x, w, b, stride,
(k - 1) // 2), LEAK)`` in float32 for the layer shapes in ``SHAPES``, the
one table that maps each ``(c_in, c_out, k, stride)`` to its kernel: V1
takes block 4's ``conv0`` and ``conv1`` and block 3's ``conv0``, V2 every
other layer of blocks 2-4 (and block 1's ``conv2``, which has block 2's
``conv2``'s shape), through its split path V2K at the two shapes of the
smallest outputs (7x10 and 4x5), whose K it splits across blocks. On a
CUDA tensor it is one launch of the shape's kernel (V2K: the split GEMM
and the sum of its splits, two launches), counted in
``launch_counts[kernel.name]`` once a layer (and V2K's two in
``launch_counts[SPLIT_NAME]``); on a CPU tensor the kernel's plain
version, its arithmetic in plain PyTorch. ``takes`` is the
towers' dispatch: a layer goes to a kernel only on the card, in float32,
with autograd off, at a shape in ``SHAPES``. Each library is built with
nvcc at first use (``build.py``), never at import, so this module imports
on a machine without CUDA.
"""

from __future__ import annotations

import ctypes
import functools
import os
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from cuahn_vio_torch.ops.cuda import build, launch_counts

HERE = os.path.dirname(os.path.abspath(__file__))
LEAK = 0.1  # the towers' LeakyReLU slope, model_to_trace.py:12 (kLeak in both sources)
SPLIT_NAME = "conv_gemm_split"  # launch_counts key of the split path's launches
SPLIT_LAUNCHES = 2  # a layer's: the split GEMM, then the sum of its splits
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
    twice that. The split path's order needs no more: a product there
    meets at most n / S + 1 roundings in its range's sum and S in the sum
    of the bias and the S ranges, then the LeakyReLU's, n / S + S + 2 <=
    n + 2 for every 1 <= S <= n / 2."""
    n = w.shape[1] * w.shape[2] * w.shape[3]
    mag = F.conv2d(x.abs(), w.abs(), b.abs(), stride, (w.shape[2] - 1) // 2)
    return 2 * (n + 2) * 2.0 ** -24 * mag


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int,
           kernels: tuple = ()) -> tuple:
    """Shapes and dtypes that a kernel and its plain version take (one of
    ``kernels``, or whichever ``SHAPES`` gives); returns (the shape key, the
    kernel)."""
    if x.dim() != 4 or w.dim() != 4 or b.dim() != 1:
        raise ValueError(f"want x (B, C, H, W), w (O, C, k, k), b (O,); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(b.shape)}")
    c_out, c_in, k, k2 = w.shape
    key = (c_in, c_out, k, stride)
    kernel = SHAPES.get(key)
    if (kernel is None or kernels and kernel not in kernels or k != k2 or x.shape[1] != c_in
            or b.shape[0] != c_out):
        taken = sorted(s for s, kern in SHAPES.items() if not kernels or kern in kernels)
        label = kernels[0].label if kernels else "V1 or V2"
        raise ValueError(f"{label} takes (c_in, c_out, k, stride) in {taken}; got x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}, "
                         f"stride {stride}")
    if not all(t.dtype == torch.float32 for t in (x, w, b)):
        raise ValueError(f"{kernel.label} takes float32; got {x.dtype}, {w.dtype}, {b.dtype}")
    return key, kernel


def lowc_conv_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    stride: int) -> torch.Tensor:
    """V1's arithmetic in plain PyTorch: each output starts at its bias and
    takes the products in (c_in, ky, kx) order over the zero-padded input,
    then the LeakyReLU. The kernel rounds each product-and-add once (an
    fma), this version twice, so the two differ by rounding alone."""
    (c_in, c_out, k, s), _ = _check(x, w, b, stride, (V1,))
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


def conv_gemm_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int,
                    splits: Optional[int] = None) -> torch.Tensor:
    """V2's function in plain PyTorch, as the same GEMM: the zero-padded
    input unfolded to (B, C_in k^2, oh ow) in (c_in, ky, kx) order, the
    filter as (C_out, C_in k^2), and the LeakyReLU of their product plus
    the bias. K is taken as ``splits`` runs of c_in (by default the
    shape's: V2K's ``splits``, else 1), each run's product alone, and the
    bias and the runs' products added in run order, as the split path adds
    them. Each product sums in the library's order, not the kernel's, so
    the two differ by rounding alone (``rounding_bound``)."""
    key, kernel = _check(x, w, b, stride, (V2, V2K))
    c_in, c_out, k, s = key
    oh, ow = out_size(x.shape[2], k, s), out_size(x.shape[3], k, s)
    cols = F.unfold(x, k, padding=(k - 1) // 2, stride=s)
    wk = w.reshape(c_out, -1)
    acc = b[:, None]
    for c0, c1 in split_runs(c_in, splits or kernel.splits.get(key, 1)):
        acc = acc + torch.matmul(wk[:, c0 * k * k:c1 * k * k], cols[:, c0 * k * k:c1 * k * k])
    return F.leaky_relu(acc.reshape(x.shape[0], c_out, oh, ow), LEAK)


def split_runs(c_in: int, splits: int) -> list:
    """The split path's runs of c_in, [(c0, c1), ...] in split order: run z
    from z c_in // splits (``conv_gemm.cu``'s division), nearly equal."""
    starts = [z * c_in // splits for z in range(splits + 1)]
    return list(zip(starts, starts[1:]))


@dataclass(frozen=True, eq=False)  # each kernel is one object: hashed and compared by identity
class Kernel:
    """One of the towers' convolution kernels and what its launches need."""

    label: str  # its name in the docs: V1, V2
    name: str  # its ``launch_counts`` key, one a layer
    symbol: str  # its ``__global__`` function, as ptxas and a trace name it
    source: str  # its CUDA source
    entry: str  # its C launcher: (x, w, bias, out, [workspace,] b, c_in, c_out, k, stride, h,
    #             w, oh, ow, stream), the workspace where ``splits`` is not empty
    init: Optional[str]  # a C function run once when the library loads, before any launch
    plain: Callable  # its arithmetic in plain PyTorch, (x, w, b, stride) -> out
    fits: Callable  # (batch, c_in, h, w, oh, ow) -> whether its grid and indexing hold them
    # the split path's shapes, each to the nearly equal runs of c_in that
    # its K is split into across blocks (the library's ``conv_gemm_splits``)
    splits: dict = field(default_factory=dict)


def _gemm_fits(bsz: int, c_in: int, h: int, w: int, oh: int, ow: int) -> bool:
    return 0 < bsz and bsz * oh * ow < 2 ** 31 - 256 and c_in * h * w < 2 ** 31


V1 = Kernel("V1", "lowc_conv", "lowc_conv_kernel", os.path.join(HERE, "conv.cu"),
            "lowc_conv_f32", None, lowc_conv_plain,
            lambda bsz, c_in, h, w, oh, ow: 0 < bsz <= 65535)
V2 = Kernel("V2", "conv_gemm", "gemm_conv_kernel", os.path.join(HERE, "conv_gemm.cu"),
            "conv_gemm_f32", "conv_gemm_init", conv_gemm_plain, _gemm_fits)
# V2's split path: each 64 x 64 tile's K split over runs of c_in across
# blocks, the partials summed by a second kernel (``sum_gemm_conv_kernel``)
V2K = Kernel("V2", "conv_gemm", "gemm_conv_kernel", V2.source, "conv_gemm_split_f32",
             "conv_gemm_init", conv_gemm_plain, _gemm_fits,
             splits={(128, 256, 3, 2): 4, (256, 256, 3, 2): 6})
KERNELS = (V1, V2, V2K)
SOURCES = tuple(dict.fromkeys(kernel.source for kernel in KERNELS))
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
    (128, 256, 3, 2): V2K,  # block 2 conv2, block 3 conv4, block 4 conv5 (and block 1 conv2)
    (256, 256, 3, 2): V2K,  # block 2 conv3, block 3 conv5, block 4 conv6
}


@functools.lru_cache(maxsize=None)
def _launcher(kernel: Kernel):
    """The kernel's C launcher, its library loaded, its ``init`` run and
    its splits checked."""
    if kernel.init is not None:
        err = build.entry(kernel.source, kernel.init, ())()  # e.g. each shape's shared memory,
        if err != 0:  # before any launch or capture
            raise RuntimeError(f"{kernel.name}: {kernel.init} failed: cudaError {err}")
    for key, splits in kernel.splits.items():
        got = build.entry(kernel.source, "conv_gemm_splits", (_I,) * 4)(*key)
        if got != splits:
            raise RuntimeError(f"{os.path.basename(kernel.source)} splits {key} {got} ways, "
                               f"conv.py {splits}")
    pointers = 5 if kernel.splits else 4  # x, w, bias, out[, workspace]
    return build.entry(kernel.source, kernel.entry, (_P,) * pointers + (_I,) * 9 + (_P,))


def build_kernel() -> float:
    """Build both libraries now; returns the compile seconds (0.0 if they
    were already built). Loading them needs a card, so it is left to the
    first launch."""
    return sum(build.build(source)[1] for source in SOURCES)


def ptxas_report() -> dict:
    """ptxas's registers, shared memory and spills of each kernel of both
    libraries (``build.ptxas_report``)."""
    return {name: info for source in SOURCES
            for name, info in build.ptxas_report(build.library_path(source)).items()}


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
    """One launch of the shape's kernel (V2K: two, into a workspace of its
    splits' partial sums and from it) on contiguous float32 CUDA tensors
    (B, c_in, H, W), (c_out, c_in, k, k) and (c_out,) -> (B, c_out, oh,
    ow); raises on anything the kernel does not take and on a failed
    launch."""
    key, kernel = _check(x, w, b, stride)
    c_in, c_out, k, s = key
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
    # the split path's partials [split][c_out][B oh ow, rounded up to a
    # multiple of 4]: from torch's allocator (under a CUDA graph's capture,
    # the graph's pool), written by the launch before it reads them
    work = [torch.empty((kernel.splits[key], c_out, -(-bsz * oh * ow // 4) * 4),
                        dtype=torch.float32, device=x.device)] if kernel.splits else []
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launcher(kernel)(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                *(t.data_ptr() for t in work), bsz, c_in, c_out, k, s, h, wd,
                                oh, ow, stream)
    if err != 0:
        raise RuntimeError(f"{kernel.name} kernel launch failed: cudaError {err}")
    launch_counts[kernel.name] += 1
    if kernel.splits:
        launch_counts[SPLIT_NAME] += SPLIT_LAUNCHES
    return out


def conv_leaky(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """The shape's kernel on a CUDA tensor (``conv_leaky_cuda``), its plain
    version on a CPU one."""
    if x.is_cuda:
        return conv_leaky_cuda(x, w, b, stride)
    return _check(x, w, b, stride)[1].plain(x, w, b, stride)
