"""ctypes binding and wrappers of V1, the low-channel convolution (``conv.cu``).

``lowc_conv(x, w, b, stride)`` is ``leaky_relu(conv2d(x, w, b, stride,
(k - 1) // 2), 0.1)`` in float32 for the layer shapes in ``SHAPES``
(``(c_in, c_out, k, stride)``: the UAHN towers' block 4 ``conv0`` and
``conv1`` and block 3 ``conv0``): on a CUDA tensor one launch of
``lowc_conv_kernel``, counted in ``launch_counts["lowc_conv"]``; on a CPU
tensor ``lowc_conv_plain``, the kernel's arithmetic in plain PyTorch.
``takes`` is the towers' dispatch: a layer goes to V1 only on the card,
in float32, with autograd off, at one of ``SHAPES``. The library is built
with nvcc at first use (``build.py``), never at import, so this module
imports on a machine without CUDA.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch
import torch.nn.functional as F

from cuahn_vio_torch.ops.cuda import build, launch_counts

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "conv.cu")
KERNEL = "lowc_conv"
SHAPES = frozenset({(2, 8, 7, 1), (8, 16, 5, 2), (2, 16, 7, 1)})  # (c_in, c_out, k, stride)
LEAK = 0.1  # the towers' LeakyReLU slope
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    # x, w, bias, out, b, c_in, c_out, k, stride, h, w, oh, ow, stream
    lib.lowc_conv_f32.argtypes = [_P, _P, _P, _P] + [_I] * 9 + [_P]
    lib.lowc_conv_f32.restype = ctypes.c_int
    return lib


def build_kernel() -> float:
    """Build and load the library now; returns the compile seconds (0.0 if
    it was already built)."""
    _, seconds = build.build(SOURCE)
    _library()
    return seconds


def ptxas_report() -> dict:
    """ptxas's registers, shared memory and spills of each layer shape's
    kernel (``build.ptxas_report``)."""
    return build.ptxas_report(build.library_path(SOURCE))


def takes(device: torch.device, dtype: torch.dtype, conv: torch.nn.Conv2d) -> bool:
    """Whether a tower runs ``conv`` on an input of ``device`` and ``dtype``
    through V1: on a CUDA device, in float32, while autograd records
    nothing, at one of ``SHAPES`` (padding (k - 1) // 2, as the towers
    build every layer). Every other layer and call keeps cuDNN's (or the
    CPU's) ``conv2d`` and a separate ``leaky_relu``."""
    k = conv.kernel_size[0]
    return (device.type == "cuda" and dtype == torch.float32 and not torch.is_grad_enabled()
            and (conv.in_channels, conv.out_channels, k, conv.stride[0]) in SHAPES
            and conv.padding[0] == (k - 1) // 2)


def out_size(n: int, k: int, stride: int) -> int:
    return (n + 2 * ((k - 1) // 2) - k) // stride + 1


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> tuple:
    """Shapes and dtypes that both versions take; returns the shape key."""
    if x.dim() != 4 or w.dim() != 4 or b.dim() != 1:
        raise ValueError(f"want x (B, C, H, W), w (O, C, k, k), b (O,); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(b.shape)}")
    c_out, c_in, k, k2 = w.shape
    key = (c_in, c_out, k, stride)
    if k != k2 or x.shape[1] != c_in or b.shape[0] != c_out or key not in SHAPES:
        raise ValueError(f"V1 takes (c_in, c_out, k, stride) in {sorted(SHAPES)}; got x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}, stride {stride}")
    if not all(t.dtype == torch.float32 for t in (x, w, b)):
        raise ValueError(f"V1 takes float32; got {x.dtype}, {w.dtype}, {b.dtype}")
    return key


def rounding_bound(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   stride: int) -> torch.Tensor:
    """Per output, how far two float32 evaluations of V1's function may lie
    apart: each sums the bias and n = c_in k^2 products, in whatever order,
    within (n + 2) u of the exact value relative to the sum of the terms'
    magnitudes (u = 2^-24; a rounding a product and one an add, or one an
    fma, and the LeakyReLU's product), so two lie within twice that."""
    n = w.shape[1] * w.shape[2] * w.shape[3]
    mag = F.conv2d(x.abs(), w.abs(), b.abs(), stride, (w.shape[2] - 1) // 2)
    return 2 * (n + 2) * 2.0 ** -24 * mag


def lowc_conv_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    stride: int) -> torch.Tensor:
    """V1's arithmetic in plain PyTorch: each output starts at its bias and
    takes the products in (c_in, ky, kx) order over the zero-padded input,
    then the LeakyReLU. The kernel rounds each product-and-add once (an
    fma), this version twice, so the two differ by rounding alone."""
    c_in, c_out, k, s = _check(x, w, b, stride)
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


def lowc_conv_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   stride: int) -> torch.Tensor:
    """One launch of V1 on contiguous float32 CUDA tensors (B, c_in, H, W),
    (c_out, c_in, k, k) and (c_out,) -> (B, c_out, oh, ow); raises on
    anything the kernel does not take and on a failed launch."""
    c_in, c_out, k, s = _check(x, w, b, stride)
    if not all(t.is_cuda for t in (x, w, b)) or len({x.device, w.device, b.device}) != 1:
        raise ValueError("lowc_conv_cuda takes CUDA tensors on one device")
    if not all(t.is_contiguous() for t in (x, w, b)):
        raise ValueError("lowc_conv_cuda takes contiguous tensors")
    bsz, _, h, wd = x.shape
    if not 0 < bsz <= 65535:
        raise ValueError(f"batch {bsz} outside the kernel's grid (1..65535)")
    oh, ow = out_size(h, k, s), out_size(wd, k, s)
    out = torch.empty((bsz, c_out, oh, ow), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().lowc_conv_f32(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                       bsz, c_in, c_out, k, s, h, wd, oh, ow, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} kernel launch failed: cudaError {err}")
    launch_counts[KERNEL] += 1
    return out


def lowc_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """V1 on a CUDA tensor (``lowc_conv_cuda``), its plain version on a CPU
    one."""
    return lowc_conv_cuda(x, w, b, stride) if x.is_cuda else lowc_conv_plain(x, w, b, stride)
