"""ctypes binding and wrapper of the remap kernel C1 (``remap.cu``).

``remap_u8_cuda``: N uint8 raw frames remapped through a float32 map into
uint8 frames, one launch for the batch. The library is built with nvcc
at first use (``build.py``), never at import. ``layout`` and ``grid`` give
the kernel's tile constants and a launch's grid.
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
    # src, map_x, map_y, dst, n, src_h, src_w, out_h, out_w, tile_paths, stream
    lib.remap_u8_batch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P]
    lib.remap_u8_batch.restype = ctypes.c_int
    lib.remap_grid.argtypes = [_I, _I, _I, _P]
    lib.remap_grid.restype = ctypes.c_int
    lib.remap_layout.argtypes = [_P]
    lib.remap_layout.restype = None
    return lib


def build_kernel() -> float:
    """Build and load the library now; returns the compile seconds (0.0 if
    it was already built)."""
    _, seconds = build.build(SOURCE)
    _library()
    return seconds


def layout() -> dict:
    """The kernel's constants: tile rows and columns, threads a block, ring
    stages, bytes a stage and bytes a copy."""
    out = (ctypes.c_int * 6)()
    _library().remap_layout(out)
    return dict(zip(("tile_rows", "tile_cols", "threads", "stages", "stage_bytes", "chunk"), out))


def grid(n: int, out_h: int, out_w: int) -> dict:
    """The grid of a launch of ``n`` frames to (out_h, out_w) on the
    current device: tiles across and down, frame chunks, frames a block."""
    out = (ctypes.c_int * 4)()
    err = _library().remap_grid(n, out_h, out_w, out)
    if err != 0:
        raise RuntimeError(f"remap kernel grid for {n} frames of {out_h}x{out_w}: cudaError {err}")
    return dict(zip(("tiles_x", "tiles_y", "chunks", "frames_per_block"), out))


def ptxas_report() -> dict:
    """ptxas's registers, shared memory and spills of the kernel."""
    return build.ptxas_report(build.library_path(SOURCE))


def remap_u8_cuda(frames: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor,
                  tile_paths: torch.Tensor | None = None) -> torch.Tensor:
    """Launch C1 on (N, H_raw, W_raw) uint8 CUDA frames and (H, W) float32
    maps -> (N, H, W) uint8. ``tile_paths``, a (2,) int32 tensor on the
    frames' device, gains the count of tiles that streamed their box
    through shared memory ([0]) and that read their taps from global
    memory ([1]). Raises on anything the kernel does not take and on a
    failed launch."""
    check_remap_args(frames, map_x, map_y)
    tensors = (frames, map_x, map_y)
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError("the remap kernel takes tensors on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the remap kernel takes contiguous tensors")
    if tile_paths is not None and (tile_paths.shape != (2,) or tile_paths.dtype != torch.int32
                                   or tile_paths.device != frames.device):
        raise ValueError("tile_paths must be a (2,) int32 tensor on the frames' device")
    n = frames.shape[0]
    if n == 0:
        raise ValueError("no frames to remap")
    check_int_indexing(frames.shape[1:], frames.stride()[1:])
    check_int_indexing(map_x.shape, map_x.stride())
    out = torch.empty((n, *map_x.shape), dtype=torch.uint8, device=frames.device)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        err = _library().remap_u8_batch(
            frames.data_ptr(), map_x.data_ptr(), map_y.data_ptr(), out.data_ptr(), n,
            frames.shape[1], frames.shape[2], *map_x.shape,
            None if tile_paths is None else tile_paths.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"remap kernel launch failed: cudaError {err}")
    launch_counts[KERNEL] += 1
    return out
