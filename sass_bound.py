#!/usr/bin/env python3
"""Count the port's CUDA kernels' SASS by issue pipe, and derive the threefry
kernel T1's issue bound from it, on one GPU machine.

    python3 sass_bound.py [--out FILE.json]

Builds ``cuahn_vio_torch/ops/cuda/prng.cu`` (T1) and ``remap.cu`` (C1)
with the port's nvcc flags, disassembles each library (``cuobjdump
-sass``; the text is kept beside ``--out``) and, for every kernel, counts
its instructions (NOPs left out) by the pipe that issues them on Hopper:

- ``alu`` (64 lanes a clock an SM): integer adds, logic, shifts and
  funnel shifts, compares, selects, byte permutes, float min/max and
  compares, moves;
- ``fma`` (128 lanes a clock an SM, FP32 on both halves): FFMA, FADD,
  FMUL; ``imad`` (IMAD, IMUL, IMAD.WIDE, IMAD.MOV...) issue on its heavy
  half only (64 lanes);
- ``xu`` (16 lanes a clock an SM): MUFU (the log2 of ``log1pf``, the
  reciprocal square root of ``sqrtf``) and the int/float conversions;
- ``lsu``, ``control`` (branches, barriers, exit), ``uniform`` (the U*
  datapath) and ``other``.

Every instruction also takes one of the SM's four issue slots a clock
(128 lanes). A loop's body (the instructions from a backward branch's
target to the branch) is counted apart, each loop on its own too. Beside
the static counts, the fewest instructions on a path from the entry to
the kernel's first unconditional EXIT (forward edges only: each loop
counted apart; a branch around a rare case, such as ``sqrtf``'s slow
path, a run's walk into the next row, a partial run's value-by-value
stores, taken), so that a count a value is one that every value issues.

T1's bound (``t1_bound``): for each mode and each shape of
``chip_smoke.PRNG_CASES`` and the UAHN's kernels (K keys), a thread of
the kernel the draw launches draws a run of R values
(``ops/cuda/prng.values_per_thread``; 1 for a kernel of one value a
thread) and searches its row once, ceil(log2 K) times the first loop's
body. A value's SM clocks are the most of total / 128, alu /
64, imad / 64, (fma + imad) / 128 and xu / 16 of (the shortest path and
the search) / R, and the bound is values x clocks / (SMs x the SM clock),
at the card's maximum SM clock (``nvidia-smi clocks.max.sm``; the
published 67 TFLOP/s FP32 is 132 SMs x 128 lanes x 2 x 1.98 GHz). Two such
bounds: the kernel's (the path and the row search, what this kernel
issues) and the draw's (the path alone / R: the threefry hash, the mode's
arithmetic and the run's share of the row's key and the store). A run's
walk into the next row (at most one a row: K - 1 walks of ~30
instructions a draw) is left out. ``chip_smoke.py`` phase 3b reports the
draw's bound beside T1's ``bound_ms``.

Both move with the code the compiler made. T1's function bound
(``t1_function_bound``) does not: it counts the operations of the function
a value, from its formula (``T1_HASH_OPS``, ``T1_MODE_OPS``), each on the
pipes that can issue it, the adds split between the ALU and IMAD pipes as
evenly as the other operations allow, and is what ``chip_smoke.py`` phase
3b reports as T1's ``bound_ms`` (with the bytes' bound, whichever is
larger).

Prints one line a kernel and a shape, and writes every number to
``--out`` (default ``cuahn_vio_torch/_build/sass_bound.json``). Fails
without a CUDA device. Uses only the port.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
LANES = {"issue": 128, "alu": 64, "imad": 64, "fma_imad": 128, "xu": 16}
PIPES = (
    ("imad", re.compile(r"^(IMAD|IMUL|IDP|IMNMX_NONE)")),
    ("fma", re.compile(r"^(FFMA|FADD|FMUL|HFMA2|HADD2|HMUL2)")),
    ("xu", re.compile(r"^(MUFU|F2I|I2F|F2F|FRND|POPC|FLO|BREV)")),
    ("uniform", re.compile(r"^U")),
    ("lsu", re.compile(r"^(LD|ST|ATOM|RED|LDG|STG|LDS|STS|LDSM|LDGSTS|LDGDEPBAR|DEPBAR|SHFL|MEMBAR"
                       r"|CCTL|ERRBAR|FENCE|SYNCS|UBLKCP)")),
    ("control", re.compile(r"^(BRA|BRX|JMP|EXIT|RET|CALL|BSSY|BSYNC|BAR|WARPSYNC|BPT|YIELD|KILL"
                           r"|NANOSLEEP|BMOV|ACQBULK|ELECT|WARPGROUP)")),
    ("alu", re.compile(r"^(IADD3|IADD|LOP3|LOP|SHF|SHL|SHR|ISETP|FSETP|PSETP|SEL|FSEL|PRMT|LEA"
                       r"|IABS|IMNMX|FMNMX|MOV|P2R|R2P|PLOP3|ISCADD|FSET|CS2R|S2R|I2FP|F2IP|F2FP"
                       r"|VOTE|IMNMX|BMSK|SGXT|VIADD|VIMNMX|REDUX)")),
)
INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*?);")
FUNC = re.compile(r"Function : (\S+)")
# a branch's target: a label, or an address after an optional predicate
# operand ("BRA P1, 0x350", "BRA !P2, 0x1c0") or a divergence token
BRANCH_TARGET = re.compile(r"BRA\S*\s+(?:!?U?P\w+,\s*)?(?:`\(([^)]+)\)|(?:\w+\s+)?0x([0-9a-f]+))")
LABEL = re.compile(r"^\s*([$.\w]+):\s*$")


def pipe_of(op: str) -> str:
    for name, pattern in PIPES:
        if pattern.match(op):
            return name
    return "other"


def count(ops) -> dict:
    out = {"total": 0}
    for op in ops:
        out["total"] += 1
        p = pipe_of(op)
        out[p] = out.get(p, 0) + 1
    return out


def shortest_path(ops, targets) -> list:
    """The opcodes on the shortest path (fewest instructions) from the first
    of ``ops`` [(addr, opcode, predicated)] to the first unpredicated EXIT,
    over fall-through and forward branch edges (``targets``: {branch addr:
    target addr}); a predicated instruction is issued either way."""
    index = {a: i for i, (a, _, _) in enumerate(ops)}
    end = next(i for i, (_, op, pred) in enumerate(ops) if op == "EXIT" and not pred)
    inf = float("inf")
    dist, prev = [inf] * (end + 1), [None] * (end + 1)
    dist[0] = 1
    for i in range(end):
        if dist[i] == inf:
            continue
        a, op, pred = ops[i]
        nexts = []
        if not ((op in ("BRA", "RET") and not pred) or op == "EXIT" and not pred):
            nexts.append(i + 1)
        t = targets.get(a)
        if t is not None and t > a and index.get(t, end + 1) <= end:
            nexts.append(index[t])
        for j in nexts:
            if dist[i] + 1 < dist[j]:
                dist[j], prev[j] = dist[i] + 1, i
    path, i = [], end
    while i is not None:
        path.append(ops[i][1])
        i = prev[i]
    return path[::-1]


def sass_pipes(text: str) -> dict:
    """{kernel: {"all": pipe counts, "loop": pipe counts of its loop bodies,
    "loop_bodies": those of each loop, by address, "straight": the rest,
    "path": those of ``shortest_path``, "loops": n, "opcodes": {opcode:
    n}}} of the ``cuobjdump -sass`` text."""
    from cuahn_vio_torch.ops.cuda.build import kernel_name

    result, name, ops, labels, branches, pending = {}, None, [], {}, [], []

    def close():
        if name is None:
            return
        addrs = [a for a, _, _ in ops]
        loops, targets = [], {}
        for at, target in branches:
            t = labels.get(target, target) if isinstance(target, str) else target
            if isinstance(t, int):
                targets[at] = t
                if t < at:  # a branch to itself ends the function
                    loops.append((t, at))
        in_loop = [any(lo <= a <= hi for lo, hi in loops) for a in addrs]
        names = [op for _, op, _ in ops]
        straight = [(a, op, pred) for (a, op, pred), il in zip(ops, in_loop) if not il]
        opcodes = {}
        for op in names:
            opcodes[op] = opcodes.get(op, 0) + 1
        bodies = [count(op for a, op in zip(addrs, names) if lo <= a <= hi)
                  for lo, hi in sorted(loops)]
        result[name] = dict(all=count(names),
                            loop=count(op for op, il in zip(names, in_loop) if il),
                            loop_bodies=bodies,
                            straight=count(op for _, op, _ in straight),
                            path=count(shortest_path(straight, targets)),
                            loops=len(loops), opcodes=dict(sorted(opcodes.items())))

    for line in text.splitlines():
        m = FUNC.search(line)
        if m:
            close()
            name = kernel_name(m.group(1))
            ops, labels, branches, pending = [], {}, [], []
            continue
        if name is None:
            continue
        m = LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSTR.search(line)
        if not m:
            continue
        addr, pred, op = int(m.group(1), 16), bool(m.group(2)), m.group(3).split(".")[0]
        for label in pending:
            labels[label] = addr
        pending = []
        if op == "NOP":
            continue
        ops.append((addr, op, pred))
        b = BRANCH_TARGET.search(line) if op in ("BRA", "BRX") else None
        if b:
            branches.append((addr, b.group(1) if b.group(1) else int(b.group(2), 16)))
    close()
    return result


def clocks_per_item(c: dict) -> tuple[float, str]:
    """The SM clocks of one thread's instruction counts ``c`` (by pipe),
    bound by the busiest of the issue slots and the pipes, and which."""
    need = {
        "issue": c.get("total", 0) / LANES["issue"],
        "alu": c.get("alu", 0) / LANES["alu"],
        "imad": c.get("imad", 0) / LANES["imad"],
        "fma_imad": (c.get("fma", 0) + c.get("imad", 0)) / LANES["fma_imad"],
        "xu": c.get("xu", 0) / LANES["xu"],
    }
    by = max(need, key=need.get)
    return need[by], by


def add(a: dict, b: dict, times: float = 1.0) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) + times * v
    return out


def t1_bound(info: dict, keys: int, values: int, run: int, sms: int, mhz: float) -> dict:
    """T1's issue bounds for a draw of ``values`` values over ``keys`` rows
    by the mode's kernel of SASS counts ``info`` (``sass_pipes``), which
    draws ``run`` values a thread: the kernel's (the shortest path and
    ceil(log2 K) bodies of the first loop, the row search, over the run)
    and the draw's (the path over the run), in ms at ``sms`` SMs of
    ``mhz``."""
    iters = math.ceil(math.log2(keys)) if keys > 1 else 0
    search = info["loop_bodies"][0] if iters else {}
    per_value = {p: n / run for p, n in add(info["path"], search, iters).items()}
    draw = {p: n / run for p, n in info["path"].items()}
    clk, by = clocks_per_item(per_value)
    draw_clk, draw_by = clocks_per_item(draw)
    to_ms = values / (sms * mhz * 1e6) * 1e3
    return dict(keys=keys, values=values, run=run, search_iterations=iters,
                per_value=per_value, clocks_per_value_per_sm=clk, bound_by=by,
                bound_ms=clk * to_ms, draw_per_value=draw, draw_clocks_per_value_per_sm=draw_clk,
                draw_bound_by=draw_by, draw_bound_ms=draw_clk * to_ms)


# T1's function a value, by the pipes that can issue each operation: the
# threefry hash (20 rounds of add, rotate and xor; 12 key adds: the key
# before the first round and 5 injections into both words; the final
# xor): 20 rotates and 21 xors on the ALU pipe, 32 adds on the ALU or the
# IMAD pipe
T1_HASH_OPS = {"alu": 41, "add": 32}
# each mode's own operations a value, as its formula has it (prng.cu's
# header): the coin's compare and its byte's select; the unit float's shift
# and or, its subtract of 1, the fma and the max; the normals' erf_inv with
# log1p counted as one log2 and its scale (x*x, 1 - x*x, the scale, the
# shift of w, 8 Horner fmas, p*x, the factor sqrt(2); w's compare and the
# edge's compare and select) and the truncated normal's clip to two bounds;
# the selects between erf_inv's two polynomials are left out (a warp that
# branches on w avoids them)
T1_MODE_OPS = {
    "bits": {},
    "uniform": {"alu": 3, "fma": 2},
    "bernoulli": {"alu": 2},
    "normal": {"alu": 6, "fma": 16, "xu": 1},
    "truncated_normal": {"alu": 8, "fma": 16, "xu": 1},
}


def t1_function_bound(mode: str, values: int, sms: int, mhz: float) -> dict:
    """T1's bound from its function alone: ``values`` values of ``mode``
    (``T1_HASH_OPS`` and ``T1_MODE_OPS``), the adds put on the ALU or the
    IMAD pipe so that the busiest of the issue slots and the pipes is least
    busy, in ms at ``sms`` SMs of ``mhz``."""
    ops = add(T1_HASH_OPS, T1_MODE_OPS[mode])
    adds, best = ops.pop("add"), None
    for on_alu in range(adds + 1):
        c = dict(ops, alu=ops.get("alu", 0) + on_alu, imad=adds - on_alu)
        c["total"] = sum(c.values())
        clk, by = clocks_per_item(c)
        if best is None or clk < best[0]:
            best = (clk, by, c)
    clk, by, c = best
    return dict(mode=mode, values=values, per_value=c, clocks_per_value_per_sm=clk, bound_by=by,
                bound_ms=clk * values / (sms * mhz * 1e6) * 1e3)


def card_clock(torch) -> tuple[int, float, float]:
    """(SMs, SM clock now, its maximum in MHz) of GPU 0."""
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    sm_mhz, max_mhz = (float(v) for v in clocks.split(","))
    return torch.cuda.get_device_properties(0).multi_processor_count, sm_mhz, max_mhz


def disassemble(library: str) -> str:
    """``cuobjdump -sass`` of a built library."""
    from cuahn_vio_torch.ops.cuda import build

    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True,
                          check=True, timeout=120).stdout


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="JSON of every number (default: _build/sass_bound.json of the port)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("sass_bound: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from cuahn_vio_torch.ops.cuda import build
    from cuahn_vio_torch.ops.cuda import prng as prng_cuda
    from cuahn_vio_torch.ops.cuda import remap as remap_cuda
    from cuahn_vio_torch.utils import prng

    args.out = args.out or os.path.join(build.BUILD_DIR, "sass_bound.json")
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    gpu = chip_smoke.gpu_name_and_power()
    sms, sm_mhz, max_mhz = card_clock(torch)
    print(f"{gpu}; {sms} SMs; SM clock {sm_mhz:.0f} MHz now, {max_mhz:.0f} MHz max", flush=True)

    result = {"gpu": gpu, "sms": sms, "sm_mhz": sm_mhz, "max_sm_mhz": max_mhz, "kernels": {},
              "t1_bound": {}}
    for mod in (prng_cuda, remap_cuda):
        path, _ = build.build(mod.SOURCE)
        text = disassemble(path)
        stem = os.path.splitext(os.path.basename(mod.SOURCE))[0]
        with open(os.path.join(out_dir, f"sass_{stem}.txt"), "w") as f:
            f.write(text)
        for kern, info in sass_pipes(text).items():
            result["kernels"][kern] = info
            print(f"  {kern}: {info['loops']} loop(s); outside loops {info['straight']}, on the "
                  f"shortest path {info['path']}; first loop's body "
                  f"{(info['loop_bodies'] or [{}])[0]}", flush=True)

    for case, counts in chip_smoke.t1_cases().items():
        for mode in chip_smoke.t1_modes(case):
            m = prng.MODE_NAMES.index(mode)
            run = prng_cuda.values_per_thread(m, sum(counts))
            row = t1_bound(result["kernels"][f"threefry_kernel<{m},{run}>"], len(counts),
                           sum(counts), run, sms, max_mhz)
            row["function"] = t1_function_bound(mode, sum(counts), sms, max_mhz)
            result["t1_bound"][f"{case} {mode}"] = row
            per_value = row["per_value"]
            pipes = ", ".join(f"{p} {n:.2f}" for p, n in sorted(per_value.items())
                              if p != "total")
            print(f"  T1 {case} {mode}: {row['values']} values, runs of {row['run']}, "
                  f"{per_value['total']:.2f} instructions a value ({pipes}), "
                  f"{row['clocks_per_value_per_sm']:.4f} SM clocks a value ({row['bound_by']}); "
                  f"kernel bound {row['bound_ms']:.6f} ms at {max_mhz:.0f} MHz; draw bound "
                  f"(no row search: {row['draw_clocks_per_value_per_sm']:.4f} clocks, "
                  f"{row['draw_bound_by']}) {row['draw_bound_ms']:.6f} ms; function bound "
                  f"({row['function']['clocks_per_value_per_sm']:.4f} clocks, "
                  f"{row['function']['bound_by']}) {row['function']['bound_ms']:.6f} ms",
                  flush=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
