"""ctypes binding and wrapper of the threefry kernel T1 (``prng.cu``).

``draw_cuda``: the flat rows of ``counts[i]`` draws of each of K keys
(bits, uniform, Bernoulli, normal or truncated normal;
``utils/prng.draw``), one launch for all rows, counted in
``launch_counts["threefry"]`` and by mode in ``threefry_launches_by_mode``.
A thread of the kernel draws a run of consecutive values
(``values_per_thread``: the longest that still leaves every SM enough
threads); in runs the Bernoulli coin is an integer compare with
``utils/prng.bernoulli_threshold`` of p, made here. The library is
built with nvcc at first use (``build.py``), never at import.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Sequence

import numpy as np
import torch

from cuahn_vio_torch.ops.cuda import build, launch_counts, threefry_launches_by_mode
from cuahn_vio_torch.utils import prng

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "prng.cu")
KERNEL = "threefry"
_P = ctypes.c_void_p
# the grid's 2^31 - 1 blocks of 128 threads of one value or more
_MAX_VALUES = (2**31 - 1) * 128
_OUT_DTYPES = {prng.BITS: torch.int32, prng.UNIFORM: torch.float32,
               prng.BERNOULLI: torch.uint8, prng.NORMAL: torch.float32,
               prng.TRUNC_NORMAL: torch.float32}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    # keys, offsets, out, k, total, mode, a, b, c, d, threshold, stream
    lib.threefry_draw.argtypes = [_P, _P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_float, ctypes.c_float, ctypes.c_float,
                                  ctypes.c_float, ctypes.c_uint, _P]
    lib.threefry_draw.restype = ctypes.c_int
    lib.threefry_values_per_thread.argtypes = [ctypes.c_int, ctypes.c_longlong]
    lib.threefry_values_per_thread.restype = ctypes.c_int
    return lib


def build_kernel() -> float:
    """Build and load the library now; returns the compile seconds (0.0 if
    it was already built)."""
    _, seconds = build.build(SOURCE)
    _library()
    return seconds


def ptxas_report() -> dict:
    """ptxas's registers, shared memory and spills of each mode's kernel."""
    return build.ptxas_report(build.library_path(SOURCE))


def values_per_thread(mode: int, total: int) -> int:
    """Values a thread of the kernel draws (its run) in a draw of ``total``
    values in ``mode`` on the current device: the mode's longest run,
    shorter where that would leave an SM too few threads."""
    return _library().threefry_values_per_thread(mode, total)


@functools.lru_cache(maxsize=None)
def _row_offsets(counts: tuple, device: str) -> torch.Tensor:
    """(K + 1,) int64 start of each row on ``device``, and the total last;
    made once for each layout of rows (the kernel reads it from device
    memory, as it reads the keys) and kept for the process: a CUDA graph
    that captured a draw (``models/uahn_graphs``) reads it at every
    replay. A program draws a few layouts, one a call site and shape."""
    return torch.tensor([0, *np.cumsum(counts)], dtype=torch.int64, device=device)


def draw_cuda(keys: torch.Tensor, counts: Sequence[int], mode: int,
              a: float = 0.0, b: float = 1.0) -> torch.Tensor:
    """Launch T1 on (K, 2) int32 CUDA keys: ``sum(counts)`` values of
    ``mode`` (``utils/prng``'s BITS, UNIFORM on [a, b), BERNOULLI with p =
    a, NORMAL, TRUNC_NORMAL on (a, b)). Raises on anything the kernel does
    not take and on a failed launch."""
    if mode not in _OUT_DTYPES:
        raise ValueError(f"unknown draw mode {mode}")
    if not keys.is_cuda or keys.dtype != torch.int32 or keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"the threefry kernel takes (K, 2) int32 CUDA keys, got "
                         f"{tuple(keys.shape)} {keys.dtype} on {keys.device}")
    if not keys.is_contiguous():
        raise ValueError("the threefry kernel takes contiguous keys")
    counts = tuple(int(c) for c in counts)
    if len(counts) != keys.shape[0] or min(counts, default=0) < 0:
        raise ValueError(f"counts {counts} do not fit {keys.shape[0]} keys")
    total = sum(counts)
    if total > _MAX_VALUES:
        raise ValueError(f"{total} values outside the kernel's grid")
    out = torch.empty(total, dtype=_OUT_DTYPES[mode], device=keys.device)
    if total == 0:
        return out
    offsets = _row_offsets(counts, str(keys.device))
    # the kernel's four floats (the truncated normal's are its uniform's
    # bounds and its clip bounds) and the Bernoulli coin's threshold
    floats = prng.truncation_bounds(a, b) if mode == prng.TRUNC_NORMAL else (a, b, 0.0, 0.0)
    threshold = prng.bernoulli_threshold(a) if mode == prng.BERNOULLI else 0
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = _library().threefry_draw(keys.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                                       len(counts), total, mode, *floats, threshold, stream)
    if err != 0:
        raise RuntimeError(f"threefry kernel launch failed: cudaError {err}")
    launch_counts[KERNEL] += 1
    threefry_launches_by_mode[prng.MODE_NAMES[mode]] += 1
    return out
