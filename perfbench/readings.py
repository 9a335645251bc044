"""The readings that a cell's limits are set from, in one process.

    python3 perfbench/readings.py --workload <cell> --seeds 11,12,13 [--control 11,12,13]
        [--units 2] [--out chiprun_out/readings.jsonl]

For each seed: the cell's set-up, ``--units`` units of its window, then
the check's numbers, once with the plain reference in the configuration's
precision (the program's readings: the lower end of each limit) and, for
the seeds in ``--control``, once with the reference computed in the next
precision below it, float32 with TF32 on (the control: the upper end).
One JSON line a seed. ``--fault`` plants one of ``lib/faults.py``'s
faults under the timed path. Not part of a benchmark run; needs a CUDA
device.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench.lib import harness  # noqa: E402


def readings(workload: str, seed: int, units: int, control: bool, device="cuda",
             overrides=None, model_factory=None) -> dict:
    import torch

    spec = harness.cell_spec(workload)
    traffic = dict(spec.traffic, **(overrides or {}))
    mod = harness.load_file(os.path.join(harness.BENCH_DIR, "work", f"{traffic['work']}.py"),
                            f"perfbench_work_{traffic['work']}")
    work = mod.Work(spec.config, traffic, seed, device, model_factory=model_factory)
    work.setup()
    for u in range(units):
        work.unit(u)
    if device != "cpu":
        torch.cuda.synchronize()
    work.release()
    out = {"workload": workload, "seed": seed}
    out["program"], out["attempted"], out["failed"] = work.check()
    out["look"] = getattr(work, "look", None)
    if control:
        out["control"] = work.check(control=True)[0]
    out["limits"] = spec.limits
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--units", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--fault", default=None, help="plant a fault of perfbench/lib/faults.py")
    args = ap.parse_args()
    harness.use_checkout_caches()
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    control = {int(s) for s in args.control.split(",") if s}
    for s in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        hook = None
        if args.fault:
            from perfbench.lib.faults import fault_hook

            hook = fault_hook(args.fault)
        r = readings(args.workload, s, args.units, s in control, model_factory=hook)
        r["fault"] = args.fault
        r["seconds"] = time.perf_counter() - t0
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
