#!/usr/bin/env python3
"""Time the remap kernel C1 (``cuahn_vio_torch/ops/cuda/remap.cu``) on one
GPU beside earlier copies of it and copies with other constants.

    python3 tune_remap.py [--baseline OLD_remap.cu ...]
                          [--variant NAME:kConst=V,kConst=V ...] [--probe PART_remap.cu ...]
                          [--out FILE.json]

Builds ``remap.cu``, each ``--baseline`` (an earlier remap.cu, e.g. from
``git show REV:cuahn_vio_torch/ops/cuda/remap.cu``: the entry point of
the earlier one-thread-a-pixel kernel is taken as well as this one's) and each
``--variant`` (a copy of this ``remap.cu`` whose named ``constexpr``
constants, e.g. ``kWarps=8,kStages=3``, take other values) and each
``--probe`` (a copy with a part of the kernel left out, to time the rest;
named ``probe_...`` and not held to the plain version), with the same
nvcc flags, all in parallel. Then:

1. per library: ptxas's registers, shared memory and spill bytes, and the
   kernel's SASS instructions by issue pipe (``sass_bound.sass_pipes``;
   the SASS is kept beside ``--out``);
2. parity of every library with ``remap_u8_plain`` on ``chip_smoke.py``'s
   maps (fisheye, radtan, edges) at N = 1, 7 and 165 raw 640x480 frames:
   bit for bit;
3. device time of every library at N = 1 and 165 on the fisheye map and
   at N = 165 on the radtan map: CUDA-graph replays (as ``chip_smoke.py``
   phase 3, hot L2) and with a cold L2 (``chip_smoke.time_cold_ms``), in
   turns: the libraries in one order, then in the reverse order, both
   times kept; ``grid_sample`` and the launch floor once an order.

Prints one line per measurement and writes every number to ``--out``
(default ``cuahn_vio_torch/_build/tune_remap.json``). Fails without a CUDA
device. Uses only the port.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import faulthandler
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WALL_LIMIT_S = 600
PARITY_FRAMES = (1, 7, 165)
CASES = (("fisheye", 1), ("fisheye", 165), ("radtan", 165))
_P, _I = ctypes.c_void_p, ctypes.c_int


def variant_source(base: str, name: str, spec: str, out_dir: str) -> str:
    """A copy of ``base`` with each ``kConst=V`` of ``spec`` set, written to
    ``out_dir/name/`` under the base's file name; raises on a constant it
    does not have."""
    with open(base) as f:
        text = f.read()
    for item in spec.split(","):
        const, value = item.split("=")
        text, hits = re.subn(rf"(constexpr \w+ {const} = )[^;]+;", rf"\g<1>{value};", text)
        if hits != 1:
            raise ValueError(f"{base} has no single constexpr {const}")
    path = os.path.join(out_dir, name, os.path.basename(base))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return path


def bind(lib: ctypes.CDLL):
    """call(frames, map_x, map_y, out) -> cudaError of ``lib``'s entry point,
    on the current stream: this kernel's, or the one-thread-a-pixel kernel's (no tile paths, the
    output given by its pixel count)."""
    import torch

    fn = lib.remap_u8_batch
    old = hasattr(lib, "remap_frames_per_thread")
    fn.argtypes = ([_P, _P, _P, _P, _I, _I, _I, _I, _P] if old else
                   [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P])
    fn.restype = ctypes.c_int

    def call(frames, mx, my, out):
        stream = torch.cuda.current_stream().cuda_stream
        n, h, w = frames.shape
        ptrs = (frames.data_ptr(), mx.data_ptr(), my.data_ptr(), out.data_ptr(), n, h, w)
        return fn(*ptrs, mx.numel(), stream) if old else fn(*ptrs, *mx.shape, None, stream)

    return call


def main() -> int:
    faulthandler.dump_traceback_later(WALL_LIMIT_S, exit=True)
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", action="append", default=[],
                    help="another remap.cu to build and time beside this one (repeatable)")
    ap.add_argument("--probe", action="append", default=[],
                    help="a remap.cu that computes something else (a part of the kernel left "
                         "out), timed but not held to the plain version (repeatable)")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME:kConst=V,...: this remap.cu with other constants (repeatable)")
    ap.add_argument("--out", default=None,
                    help="JSON of every number (default: _build/tune_remap.json of the port)")
    args = ap.parse_args()

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("tune_remap: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    import sass_bound
    from cuahn_vio_torch.ops.cuda import build
    from cuahn_vio_torch.ops.cuda import remap as remap_cuda
    from cuahn_vio_torch.ops.remap import remap_u8_plain

    args.out = args.out or os.path.join(build.BUILD_DIR, "tune_remap.json")
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    gpu = chip_smoke.gpu_name_and_power()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {gpu}", flush=True)

    sources = {"current": remap_cuda.SOURCE}
    for i, path in enumerate(args.baseline):
        name = os.path.splitext(os.path.basename(path))[0]
        sources[name if name not in sources else f"{name}{i}"] = os.path.abspath(path)
    for path in args.probe:
        sources["probe_" + os.path.splitext(os.path.basename(path))[0]] = os.path.abspath(path)
    for spec in args.variant:
        name, consts = spec.split(":", 1)
        sources[name] = variant_source(remap_cuda.SOURCE, name, consts,
                                       os.path.join(build.BUILD_DIR, "tune_remap"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        paths = dict(zip(sources, pool.map(lambda src: build.build(src)[0], sources.values())))
    print(f"[build] {time.perf_counter() - t0:.1f} s, {len(paths)} libraries", flush=True)

    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    result = {"gpu": gpu, "libraries": {}, "times": []}
    for name, path in paths.items():
        ptxas = build.ptxas_report(path)["remap_kernel"]
        text = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                              check=True, timeout=120).stdout
        with open(os.path.join(out_dir, f"sass_remap_{name}.txt"), "w") as f:
            f.write(text)
        pipes = sass_bound.sass_pipes(text)["remap_kernel"]
        result["libraries"][name] = dict(source=sources[name], ptxas=ptxas, sass=pipes)
        print(f"  {name:12s} regs {ptxas['registers']} smem {ptxas['smem_bytes']} spill st/ld "
              f"{ptxas['spill_stores']}/{ptxas['spill_loads']} | SASS {pipes['all']}; in loops "
              f"{pipes['loop']}", flush=True)
    calls = {name: bind(ctypes.CDLL(path)) for name, path in paths.items()}
    for name, path in paths.items():
        lib = ctypes.CDLL(path)
        if hasattr(lib, "remap_grid"):
            grids = {}
            for n in (1, 165):
                out = (ctypes.c_int * 4)()
                lib.remap_grid(n, 224, 320, out)
                grids[n] = list(out)
            result["libraries"][name]["grid"] = grids
            print(f"  {name:12s} grid (tiles across, down, frame chunks, frames a block): "
                  f"N=1 {grids[1]}, N=165 {grids[165]}", flush=True)

    maps = chip_smoke.remap_maps(torch, dev)
    rng = np.random.default_rng(11)
    frames = {n: torch.as_tensor(rng.integers(0, 256, (n, 480, 640)).astype(np.uint8),
                                 device=dev) for n in PARITY_FRAMES}
    t0 = time.perf_counter()
    for kind, (mx, my) in maps.items():
        for n, raw in frames.items():
            ref = remap_u8_plain(raw, mx, my)
            for name, call in calls.items():
                if name.startswith("probe_"):
                    continue
                out = torch.empty((n, *mx.shape), dtype=torch.uint8, device=dev)
                if call(raw, mx, my, out) != 0:
                    raise RuntimeError(f"{name}: launch failed ({kind}, N={n})")
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    err = int((out.int() - ref.int()).abs().max())
                    raise AssertionError(f"{name} {kind} N={n}: max abs err {err} levels")
    print(f"[parity] {time.perf_counter() - t0:.1f} s: every library bit-identical to the "
          "plain version", flush=True)

    names = list(calls)
    one = torch.zeros(1, device=dev)
    spill = torch.ones(chip_smoke.L2_FLUSH_BYTES // 4, device=dev)
    spill_sum = torch.zeros((), device=dev)

    def flush():
        torch.sum(spill, dim=0, out=spill_sum)

    for kind, n in CASES:
        mx, my = maps[kind]
        raw = frames[n]
        out = torch.empty((n, *mx.shape), dtype=torch.uint8, device=dev)
        runs = {name: (lambda c=calls[name]: c(raw, mx, my, out)) for name in names}
        frames_f = raw.float()[:, None]
        grid = torch.stack([2 * mx / 639.0 - 1, 2 * my / 479.0 - 1], dim=-1)[None].expand(
            n, *mx.shape, 2)
        hot = {name: [] for name in names}
        cold = {name: [] for name in names}
        lib_ms, floor_ms = [], []
        for order in (names, names[::-1]):
            lib_ms.append(chip_smoke.time_graph_ms(torch, lambda: F.grid_sample(
                frames_f, grid, mode="bilinear", padding_mode="zeros", align_corners=True)))
            floor_ms.append(chip_smoke.time_graph_ms(torch, lambda: one.add_(1.0)))
            for name in order:
                hot[name].append(chip_smoke.time_graph_ms(torch, runs[name]))
                cold[name].append(chip_smoke.time_cold_ms(torch, runs[name], flush))
        bound, footprint = chip_smoke.remap_bound_ms(torch, n, mx, my, 480, 640)
        result["times"].append(dict(map=kind, n=n, bound_ms=bound, footprint=footprint,
                                    grid_sample_ms=lib_ms, launch_floor_ms=floor_ms,
                                    ms=hot, cold_ms=cold))
        print(f"  {kind} N={n}: grid_sample {lib_ms[0]:.5f}/{lib_ms[1]:.5f} ms, launch floor "
              f"{floor_ms[0]:.5f}/{floor_ms[1]:.5f} ms, byte bound {bound:.5f} ms "
              f"({footprint} raw bytes a frame)", flush=True)
        for name in names:
            h = sum(hot[name]) / 2
            print(f"    {name:12s} hot {hot[name][0]:.5f}/{hot[name][1]:.5f} ms "
                  f"({bound / h:.3f} of the bound), cold {cold[name][0]:.5f}/{cold[name][1]:.5f}"
                  f" ms", flush=True)

    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    result["sm_clocks_after_timing"] = clocks
    print(f"SM clock after timing, and its maximum: {clocks}", flush=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
