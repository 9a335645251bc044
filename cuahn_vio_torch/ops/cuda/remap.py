"""ctypes binding and wrapper of the remap kernel C1 (``remap.cu``).

``remap_u8_cuda``: N uint8 raw frames remapped through a float32 map into
uint8 frames, one launch for the batch. The library is built with nvcc
at first use (``build.py``), never at import.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from cuahn_vio_torch.ops.cuda import build, launch_counts
from cuahn_vio_torch.ops.cuda.warp import check_int_indexing
from cuahn_vio_torch.ops.remap import check_remap_args

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "remap.cu")
KERNEL = "remap"
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    # src, map_x, map_y, dst, n, src_h, src_w, out_pix, stream
    lib.remap_u8_batch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
    lib.remap_u8_batch.restype = ctypes.c_int
    lib.remap_frames_per_thread.restype = ctypes.c_int
    return lib


def build_kernel() -> float:
    """Build and load the library now; returns the compile seconds (0.0 if
    it was already built)."""
    _, seconds = build.build(SOURCE)
    _library()
    return seconds


def frames_per_thread() -> int:
    """Frames that one thread of the kernel remaps (the map is read once per
    thread)."""
    return _library().remap_frames_per_thread()


def ptxas_report() -> dict:
    """ptxas's registers, shared memory and spills of the kernel."""
    return build.ptxas_report(build.library_path(SOURCE))


def remap_u8_cuda(frames: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor) -> torch.Tensor:
    """Launch C1 on (N, H_raw, W_raw) uint8 CUDA frames and (H, W) float32
    maps -> (N, H, W) uint8. Raises on anything the kernel does not take
    and on a failed launch."""
    check_remap_args(frames, map_x, map_y)
    tensors = (frames, map_x, map_y)
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError("the remap kernel takes tensors on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the remap kernel takes contiguous tensors")
    n = frames.shape[0]
    if not 0 < n <= 65535 * frames_per_thread():
        raise ValueError(f"{n} frames outside the kernel's grid")
    check_int_indexing(frames.shape[1:], frames.stride()[1:])
    check_int_indexing(map_x.shape, map_x.stride())
    out = torch.empty((n, *map_x.shape), dtype=torch.uint8, device=frames.device)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        err = _library().remap_u8_batch(frames.data_ptr(), map_x.data_ptr(), map_y.data_ptr(),
                                        out.data_ptr(), n, frames.shape[1], frames.shape[2],
                                        map_x.numel(), stream)
    if err != 0:
        raise RuntimeError(f"remap kernel launch failed: cudaError {err}")
    launch_counts[KERNEL] += 1
    return out
