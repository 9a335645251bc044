"""ctypes bindings and wrappers of the sampling kernels (``warp.cu``).

- ``homography_warp_cuda``: the homography warp (B1, and B2 with B > 1);
- ``homography_warp_rowskip_cuda``: the row-band batched warp (B3);
- ``bilinear_sample_cuda``: the flat-coordinate sampler (B4).

The library is built with nvcc at first use (``build.py``), never at
import, so this module imports on a machine without CUDA.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from cuahn_vio_torch.ops.cuda import build, launch_counts
from cuahn_vio_torch.ops.warp import check_sample_args, check_warp_args

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "warp.cu")
KERNEL = "homography_warp"
ROWSKIP_KERNEL = "homography_warp_rowskip"
SAMPLE_KERNEL = "bilinear_sample"
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = {
    # imgs, hs, out, B, H, W, image strides (3), homography batch stride, stream
    "homography_warp": [_P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _P],
    # imgs (contiguous), hs, out, B, H, W, homography batch stride, stream
    "homography_warp_rowskip": [_P, _P, _P, _I, _I, _I, _L, _P],
    # imgs, su, sv, out (contiguous (B, N)), B, N, H, W, image strides (3), stream
    "bilinear_sample_batch": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _P],
}
_INT_MAX = 2**31 - 1


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = bind(build.load(SOURCE))
    lib.warp_pixels_per_thread.argtypes = [_I, _I, _I]
    for fn in (lib.warp_threads_per_block, lib.warp_pixels_per_thread, lib.rowskip_band_bytes):
        fn.restype = ctypes.c_int
    return lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the kernels' C launchers in a library built from ``warp.cu``
    (this one, or an earlier one, which may lack some of them)."""
    for stem, argtypes in _ARGTYPES.items():
        for suffix in ("u8", "f32"):
            fn = getattr(lib, f"{stem}_{suffix}", None)
            if fn is None:
                continue
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def build_kernel() -> float:
    """Build and load the library now; returns the compile seconds (0.0 if
    it was already built)."""
    _, seconds = build.build(SOURCE)
    _library()
    return seconds


def threads_per_block() -> int:
    """Threads per block of the warp kernels."""
    return _library().warp_threads_per_block()


def pixels_per_thread(b: int, hgt: int, wid: int) -> int:
    """Adjacent output pixels per thread of the warp kernels' launch on B
    hgt x wid images on the current card (a tile of the row-band kernel is
    ``threads_per_block()`` of these runs)."""
    return _library().warp_pixels_per_thread(b, hgt, wid)


def band_bytes() -> int:
    """Bytes of the row-band kernel's shared band: a tile whose rows need
    more reads its taps from global memory."""
    return _library().rowskip_band_bytes()


def ptxas_report() -> dict:
    """ptxas's registers, shared memory and spills of each kernel of the
    built library (``build.ptxas_report``)."""
    return build.ptxas_report(build.library_path(SOURCE))


def _entry(stem: str, dtype: torch.dtype):
    return getattr(_library(), f"{stem}_{'u8' if dtype == torch.uint8 else 'f32'}")


def _check_cuda(*tensors: torch.Tensor) -> None:
    """All on one CUDA device and contiguous."""
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the CUDA kernels take CUDA tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"tensors on several devices: {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernels take contiguous tensors")


def check_int_indexing(shape, strides) -> None:
    """The kernels index images, outputs and their threads with 32-bit
    ints: raise unless the element count of ``shape`` (with a block of
    threads to spare) and every element offset that ``strides`` give fit
    in int."""
    count, last = 1, 0
    for n, st in zip(shape, strides):
        count *= n
        last += (n - 1) * st
    if count > _INT_MAX - 1024 or last > _INT_MAX or max(strides) > _INT_MAX:
        raise ValueError(f"shape {tuple(shape)}, strides {tuple(strides)} exceed the "
                         "kernels' int indexing")


def _check_warp(imgs: torch.Tensor, h_uv: torch.Tensor) -> None:
    check_warp_args(imgs, h_uv)
    _check_cuda(imgs, h_uv)
    b = imgs.shape[0]
    if not 0 < b <= 65535:
        raise ValueError(f"batch {b} outside the kernel's grid (1..65535)")
    check_int_indexing(imgs.shape, imgs.stride())


def _launch(name: str, fn, *args, device: torch.device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launch_counts[name] += 1


def homography_warp_cuda(imgs: torch.Tensor, h_uv: torch.Tensor) -> torch.Tensor:
    """Launch the warp kernel on (B, H, W) uint8|float32 CUDA images and
    (B, 3, 3) float32 homographies; returns (B, H, W) float32. Raises on
    anything the kernel does not take and on a failed launch."""
    _check_warp(imgs, h_uv)
    b, hgt, wid = imgs.shape
    out = torch.empty((b, hgt, wid), dtype=torch.float32, device=imgs.device)
    _launch(KERNEL, _entry("homography_warp", imgs.dtype),
            imgs.data_ptr(), h_uv.data_ptr(), out.data_ptr(),
            b, hgt, wid, *imgs.stride(), h_uv.stride(0), device=imgs.device)
    return out


def homography_warp_rowskip_cuda(imgs: torch.Tensor, h_uv: torch.Tensor) -> torch.Tensor:
    """The row-band batched warp: the same function as
    ``homography_warp_cuda``, bit for bit, with each tile of output pixels
    sampling a shared-memory copy of only the image rows its taps read."""
    _check_warp(imgs, h_uv)
    b, hgt, wid = imgs.shape
    out = torch.empty((b, hgt, wid), dtype=torch.float32, device=imgs.device)
    _launch(ROWSKIP_KERNEL, _entry("homography_warp_rowskip", imgs.dtype),
            imgs.data_ptr(), h_uv.data_ptr(), out.data_ptr(),
            b, hgt, wid, h_uv.stride(0), device=imgs.device)
    return out


def bilinear_sample_cuda(img: torch.Tensor, su: torch.Tensor, sv: torch.Tensor) -> torch.Tensor:
    """Sample one (H, W) uint8|float32 CUDA image at (N,) float32 pixel
    coordinates -> (N,) float32, or (B, H, W) images, each at its row of
    (B, N) coordinates -> (B, N): one launch of the flat sampler."""
    check_sample_args(img, su, sv)
    _check_cuda(img, su, sv)
    imgs = img if img.dim() == 3 else img[None]
    b, n = imgs.shape[0], su.shape[-1]
    if not 0 < b <= 65535:
        raise ValueError(f"batch {b} outside the kernel's grid (1..65535)")
    if not 0 < b * n <= _INT_MAX - 2048:
        raise ValueError(f"{b} x {n} sample points outside the kernel's int indexing")
    check_int_indexing(imgs.shape[1:], imgs.stride()[1:])
    out = torch.empty(su.shape, dtype=torch.float32, device=img.device)
    _launch(SAMPLE_KERNEL, _entry("bilinear_sample_batch", img.dtype),
            imgs.data_ptr(), su.data_ptr(), sv.data_ptr(), out.data_ptr(),
            b, n, *imgs.shape[1:], *imgs.stride(), device=img.device)
    return out
