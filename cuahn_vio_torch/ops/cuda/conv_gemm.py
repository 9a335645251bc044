"""ctypes binding and wrappers of V2, the towers' implicit-GEMM convolution
(``conv_gemm.cu``).

``conv_gemm(x, w, b, stride)`` is ``leaky_relu(conv2d(x, w, b, stride,
(k - 1) // 2), 0.1)`` in float32 for the layer shapes in ``SHAPES``
(``(c_in, c_out, k, stride)``: every layer of the UAHN towers' blocks 2-4
that V1 does not take): on a CUDA tensor one launch of
``gemm_conv_kernel``, counted in ``launch_counts["conv_gemm"]``; on a CPU
tensor ``conv_gemm_plain``, the same sums in plain PyTorch. ``takes`` is
the towers' dispatch: a layer goes to V2 only on the card, in float32,
with autograd off, at one of ``SHAPES``. The library is built with nvcc at
first use (``build.py``), never at import, so this module imports on a
machine without CUDA.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch
import torch.nn.functional as F

from cuahn_vio_torch.ops.cuda import build, launch_counts
# V1's rounding bound holds for any order of V2's sums too
from cuahn_vio_torch.ops.cuda.conv import LEAK, out_size, rounding_bound  # noqa: F401

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "conv_gemm.cu")
KERNEL = "conv_gemm"
SHAPES = frozenset({  # (c_in, c_out, k, stride)
    (2, 64, 7, 2),  # block 2 conv0
    (64, 128, 5, 2),  # block 2 conv1
    (16, 32, 5, 2),  # block 3 conv1
    (16, 32, 3, 2),  # block 4 conv2
    (32, 64, 3, 2),  # block 3 conv2, block 4 conv3
    (64, 128, 3, 2),  # block 3 conv3, block 4 conv4
    (128, 256, 3, 2),  # block 2 conv2, block 3 conv4, block 4 conv5 (and block 1 conv2)
    (256, 256, 3, 2),  # block 2 conv3, block 3 conv5, block 4 conv6
})
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    # x, w, bias, out, b, c_in, c_out, k, stride, h, w, oh, ow, stream
    lib.conv_gemm_f32.argtypes = [_P, _P, _P, _P] + [_I] * 9 + [_P]
    lib.conv_gemm_f32.restype = ctypes.c_int
    lib.conv_gemm_init.argtypes = []
    lib.conv_gemm_init.restype = ctypes.c_int
    err = lib.conv_gemm_init()  # each shape's shared memory, before any launch or capture
    if err != 0:
        raise RuntimeError(f"{KERNEL}: setting the kernels' shared memory failed: cudaError {err}")
    return lib


def build_kernel() -> float:
    """Build the library now; returns the compile seconds (0.0 if it was
    already built). Loading it needs a card, so it is left to the first
    launch."""
    _, seconds = build.build(SOURCE)
    return seconds


def ptxas_report() -> dict:
    """ptxas's registers, shared memory and spills of each layer shape's
    kernel (``build.ptxas_report``)."""
    return build.ptxas_report(build.library_path(SOURCE))


def takes(device: torch.device, dtype: torch.dtype, conv: torch.nn.Conv2d) -> bool:
    """Whether a tower runs ``conv`` on an input of ``device`` and ``dtype``
    through V2: on a CUDA device, in float32, while autograd records
    nothing, at one of ``SHAPES`` (padding (k - 1) // 2, as the towers
    build every layer). The towers ask V1 first; every layer neither takes
    keeps cuDNN's (or the CPU's) ``conv2d`` and a separate ``leaky_relu``."""
    k = conv.kernel_size[0]
    return (device.type == "cuda" and dtype == torch.float32 and not torch.is_grad_enabled()
            and (conv.in_channels, conv.out_channels, k, conv.stride[0]) in SHAPES
            and conv.padding[0] == (k - 1) // 2)


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> tuple:
    """Shapes and dtypes that both versions take; returns the shape key."""
    if x.dim() != 4 or w.dim() != 4 or b.dim() != 1:
        raise ValueError(f"want x (B, C, H, W), w (O, C, k, k), b (O,); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(b.shape)}")
    c_out, c_in, k, k2 = w.shape
    key = (c_in, c_out, k, stride)
    if k != k2 or x.shape[1] != c_in or b.shape[0] != c_out or key not in SHAPES:
        raise ValueError(f"V2 takes (c_in, c_out, k, stride) in {sorted(SHAPES)}; got x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}, "
                         f"stride {stride}")
    if not all(t.dtype == torch.float32 for t in (x, w, b)):
        raise ValueError(f"V2 takes float32; got {x.dtype}, {w.dtype}, {b.dtype}")
    return key


def conv_gemm_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    stride: int) -> torch.Tensor:
    """V2's function in plain PyTorch, as the same GEMM: the zero-padded
    input unfolded to (B, C_in k^2, oh ow) in (c_in, ky, kx) order, the
    filter as (C_out, C_in k^2), their product plus the bias, then the
    LeakyReLU. The product sums in the library's order, not the kernel's,
    so the two differ by rounding alone (``rounding_bound``)."""
    c_in, c_out, k, s = _check(x, w, b, stride)
    oh, ow = out_size(x.shape[2], k, s), out_size(x.shape[3], k, s)
    cols = F.unfold(x, k, padding=(k - 1) // 2, stride=s)
    acc = torch.matmul(w.reshape(c_out, -1), cols) + b[:, None]
    return F.leaky_relu(acc.reshape(x.shape[0], c_out, oh, ow), LEAK)


def conv_gemm_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   stride: int) -> torch.Tensor:
    """One launch of V2 on contiguous float32 CUDA tensors (B, c_in, H, W),
    (c_out, c_in, k, k) and (c_out,) -> (B, c_out, oh, ow); raises on
    anything the kernel does not take and on a failed launch."""
    c_in, c_out, k, s = _check(x, w, b, stride)
    if not all(t.is_cuda for t in (x, w, b)) or len({x.device, w.device, b.device}) != 1:
        raise ValueError("conv_gemm_cuda takes CUDA tensors on one device")
    if not all(t.is_contiguous() for t in (x, w, b)):
        raise ValueError("conv_gemm_cuda takes contiguous tensors")
    bsz, _, h, wd = x.shape
    oh, ow = out_size(h, k, s), out_size(wd, k, s)
    if bsz == 0 or bsz * oh * ow >= 2 ** 31 - 256 or c_in * h * wd >= 2 ** 31:
        raise ValueError(f"batch {bsz} of {tuple(x.shape[1:])} outside the kernel's indexing")
    out = torch.empty((bsz, c_out, oh, ow), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().conv_gemm_f32(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                       bsz, c_in, c_out, k, s, h, wd, oh, ow, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} kernel launch failed: cudaError {err}")
    launch_counts[KERNEL] += 1
    return out


def conv_gemm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """V2 on a CUDA tensor (``conv_gemm_cuda``), its plain version on a CPU
    one."""
    return conv_gemm_cuda(x, w, b, stride) if x.is_cuda else conv_gemm_plain(x, w, b, stride)
