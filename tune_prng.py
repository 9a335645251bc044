#!/usr/bin/env python3
"""Time the threefry kernel T1 (``cuahn_vio_torch/ops/cuda/prng.cu``) on one
GPU beside earlier copies of it and copies with other constants.

    python3 tune_prng.py [--baseline OLD_prng.cu ...]
                         [--variant NAME:kConst=V,kConst=V ...] [--rounds N] [--out FILE.json]

Builds ``prng.cu``, each ``--baseline`` (an earlier prng.cu, e.g. from
``git show REV:cuahn_vio_torch/ops/cuda/prng.cu``: the entry point of the
earlier one-value-a-thread kernel, which takes p itself, is taken as well
as this one's) and each ``--variant`` (a copy of this ``prng.cu`` whose
named ``constexpr`` constants, e.g. ``kThreads=128,kRunMask=8``, take
other values), with the same nvcc flags, all in parallel. Then:

1. per library: each kernel's ptxas registers and spill bytes and its
   SASS by issue pipe (``sass_bound.sass_pipes``; the SASS is kept beside
   ``--out``), a kernel for each mode and run of values a thread;
2. parity of every library with ``utils/prng.draw_plain`` at every case
   of ``chip_smoke.t1_cases`` in the modes ``chip_smoke.t1_modes`` gives
   it: bits, uniform and bernoulli bit for bit, the normals within
   ``chip_smoke.PRNG_NORMAL_ULPS`` ulp, and the values where a library's
   normals differ from the first library's counted;
3. device time of every library at those cases and modes: CUDA-graph
   replays (as ``chip_smoke.py`` phase 3b), in turns: ``--rounds`` times
   (default 1) the libraries in one order, then in the reverse order,
   the order rotated by one each round so that every library takes every
   place, every time kept; the launch floor once an order; each
   library's median and quartiles, its run there, the function's bound
   (``sass_bound.t1_function_bound``) and issue bounds from the SASS of
   the kernel it launches (``sass_bound.t1_bound``: the kernel's, with its
   row search, and the draw's) at the card's maximum SM clock.

Prints one line per measurement and writes every number to ``--out``
(default ``cuahn_vio_torch/_build/tune_prng.json``). Fails without a CUDA
device. Uses only the port.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import faulthandler
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WALL_LIMIT_S = 600
_P, _F = ctypes.c_void_p, ctypes.c_float


def bind(lib: ctypes.CDLL):
    """(call, run) of ``lib``'s entry point: call(keys, offsets, out, k,
    total, mode, floats, p) -> cudaError on the current stream (this
    kernel's takes the Bernoulli threshold of p, the one-value-a-thread
    kernel p itself, as its first float); run(mode, total) -> (values a
    thread, the kernel's name in ``sass_bound.sass_pipes``)."""
    import torch

    from cuahn_vio_torch.utils import prng

    fn = lib.threefry_draw
    old = not hasattr(lib, "threefry_values_per_thread")
    fn.argtypes = [_P, _P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _F, _F, _F, _F,
                   *([] if old else [ctypes.c_uint]), _P]
    fn.restype = ctypes.c_int
    if not old:
        lib.threefry_values_per_thread.argtypes = [ctypes.c_int, ctypes.c_longlong]

    def call(keys, offsets, out, k, total, mode, floats, p):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (keys.data_ptr(), offsets.data_ptr(), out.data_ptr(), k, total, mode, *floats)
        if old:
            return fn(*ptrs, stream)
        return fn(*ptrs, prng.bernoulli_threshold(p) if mode == prng.BERNOULLI else 0, stream)

    def run(mode, total):
        if old:
            return 1, f"threefry_kernel<{mode}>"
        r = lib.threefry_values_per_thread(mode, total)
        return r, f"threefry_kernel<{mode},{r}>"

    return call, run


def main() -> int:
    faulthandler.dump_traceback_later(WALL_LIMIT_S, exit=True)
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", action="append", default=[],
                    help="another prng.cu to build and time beside this one (repeatable)")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME:kConst=V,...: this prng.cu with other constants (repeatable)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="pairs of turns (one order, then the reverse) at each case")
    ap.add_argument("--out", default=None,
                    help="JSON of every number (default: _build/tune_prng.json of the port)")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("tune_prng: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    import sass_bound
    from cuahn_vio_torch.ops.cuda import build
    from cuahn_vio_torch.ops.cuda import prng as prng_cuda
    from cuahn_vio_torch.utils import prng
    from tune_remap import variant_source

    args.out = args.out or os.path.join(build.BUILD_DIR, "tune_prng.json")
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    gpu = chip_smoke.gpu_name_and_power()
    sms, sm_mhz, max_mhz = sass_bound.card_clock(torch)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {gpu}; {sms} SMs, SM clock "
          f"{sm_mhz:.0f} MHz now, {max_mhz:.0f} max", flush=True)

    sources = {"current": prng_cuda.SOURCE}
    for i, path in enumerate(args.baseline):
        name = os.path.splitext(os.path.basename(path))[0]
        sources[name if name not in sources else f"{name}{i}"] = os.path.abspath(path)
    for spec in args.variant:
        name, consts = spec.split(":", 1)
        sources[name] = variant_source(prng_cuda.SOURCE, name, consts,
                                       os.path.join(build.BUILD_DIR, "tune_prng"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        paths = dict(zip(sources, pool.map(lambda src: build.build(src)[0], sources.values())))
    print(f"[build] {time.perf_counter() - t0:.1f} s, {len(paths)} libraries", flush=True)

    result = {"gpu": gpu, "sms": sms, "max_sm_mhz": max_mhz, "libraries": {}, "times": []}
    calls, runs, pipes = {}, {}, {}
    for name, path in paths.items():
        calls[name], runs[name] = bind(ctypes.CDLL(path))
        ptxas = build.ptxas_report(path)
        text = sass_bound.disassemble(path)
        with open(os.path.join(out_dir, f"sass_prng_{name}.txt"), "w") as f:
            f.write(text)
        pipes[name] = sass_bound.sass_pipes(text)
        result["libraries"][name] = dict(source=sources[name], ptxas=ptxas, sass=pipes[name])
        for kern, comp in sorted(ptxas.items()):
            info = pipes[name][kern]
            print(f"  {name:10s} {kern:22s} regs {comp['registers']}, spill st/ld "
                  f"{comp['spill_stores']}/{comp['spill_loads']} | SASS path {info['path']}; "
                  f"first loop {(info['loop_bodies'] or [{}])[0]}", flush=True)

    names = list(calls)
    cases = chip_smoke.t1_cases()
    work = []
    t0 = time.perf_counter()
    for case, counts in cases.items():
        keys = prng.keys_tensor(prng.split(prng.prng_key(len(counts)), len(counts)), dev)
        offsets = torch.tensor([0, *np.cumsum(counts)], dtype=torch.int64, device=dev)
        total = sum(counts)
        for mode_name in chip_smoke.t1_modes(case):
            mode = prng.MODE_NAMES.index(mode_name)
            a, b = chip_smoke.T1_MODE_ARGS[mode_name]
            floats = (prng.truncation_bounds(a, b) if mode == prng.TRUNC_NORMAL
                      else (a, b, 0.0, 0.0))
            ref = prng.draw_plain(keys, counts, mode, a, b)
            outs = {}
            for name in names:
                out = torch.empty_like(ref)
                if calls[name](keys, offsets, out, len(counts), total, mode, floats, a) != 0:
                    raise RuntimeError(f"{name}: launch failed ({case} {mode_name})")
                torch.cuda.synchronize()
                if mode in (prng.NORMAL, prng.TRUNC_NORMAL):
                    ulps = int((out.view(torch.int32).long() - ref.view(torch.int32).long())
                               .abs().max())
                    if ulps > chip_smoke.PRNG_NORMAL_ULPS:
                        raise AssertionError(f"{name} {case} {mode_name}: {ulps} ulp")
                elif not torch.equal(out, ref):
                    raise AssertionError(f"{name} {case} {mode_name}: not the plain version")
                outs[name] = out
            unequal = {name: int((outs[name] != outs[names[0]]).sum()) for name in names}
            work.append((case, counts, keys, offsets, total, mode, mode_name, floats, a, unequal,
                         ref.dtype))
    print(f"[parity] {time.perf_counter() - t0:.1f} s: every library its plain version's "
          "(bits, uniform, bernoulli bit for bit; normals within "
          f"{chip_smoke.PRNG_NORMAL_ULPS} ulp)", flush=True)

    one = torch.zeros(1, device=dev)
    for case, counts, keys, offsets, total, mode, mode_name, floats, a, unequal, dtype in work:
        out = torch.empty(total, dtype=dtype, device=dev)
        runs_of = {name: (lambda c=calls[name]: c(keys, offsets, out, len(counts), total, mode,
                                                  floats, a)) for name in names}
        ms = {name: [] for name in names}
        floor_ms = []
        for r in range(args.rounds):
            turn = names[r % len(names):] + names[:r % len(names)]
            for order in (turn, turn[::-1]):
                floor_ms.append(chip_smoke.time_graph_ms(torch, lambda: one.add_(1.0)))
                for name in order:
                    ms[name].append(chip_smoke.time_graph_ms(torch, runs_of[name]))
        function = sass_bound.t1_function_bound(mode_name, total, sms, max_mhz)
        bounds, quartiles = {}, {}
        for name in names:
            run, kern = runs[name](mode, total)
            bounds[name] = sass_bound.t1_bound(pipes[name][kern], len(counts), total, run, sms,
                                               max_mhz)
            quartiles[name] = [float(q) for q in np.percentile(ms[name], [25, 50, 75])]
        result["times"].append(dict(case=case, mode=mode_name, keys=len(counts), values=total,
                                    launch_floor_ms=floor_ms, ms=ms, quartiles_ms=quartiles,
                                    unequal_to_first=unequal, bounds=bounds,
                                    function_bound=function))
        print(f"  {case} {mode_name}: {total} values, launch floor "
              f"{'/'.join(f'{t:.5f}' for t in floor_ms)} ms; function bound "
              f"{function['bound_ms']:.5f} ms ({function['bound_by']})", flush=True)
        for name in names:
            bd = bounds[name]
            lo, med, hi = quartiles[name]
            print(f"    {name:12s} run {bd['run']:2d} median {med:.5f} ms [{lo:.5f}, {hi:.5f}] "
                  f"({function['bound_ms'] / med:.3f} of the function bound); SASS bound kernel "
                  f"{bd['bound_ms']:.5f} ({bd['bound_ms'] / med:.3f}), draw "
                  f"{bd['draw_bound_ms']:.5f} ({bd['draw_bound_ms'] / med:.3f}, "
                  f"{bd['draw_bound_by']}); {unequal[name]} values unequal to {names[0]}'s",
                  flush=True)

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
