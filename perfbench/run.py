"""Run one benchmark cell once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program (``cuahn_vio_torch``)
and ``BENCHMARK.json``. Needs a CUDA device (as many as the cell asks
for); without one it exits 2 and prints no result. Set-up (imports, the
program's kernels from its build cache, weights, inputs, warm-up of the
cell's shapes) is timed as ``setup_s``; then the window runs for
``--seconds`` (``--trace 0``: the end-to-end metrics) or runs the
traffic's ``trace_units`` under ``torch.profiler`` (``--trace 1``: the
per-layer metrics). After the window the plain reference checks the
outputs; each compared number is printed with its limit on standard
error and under ``checks`` in the result, the last line of standard
output.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench.lib import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    harness.use_checkout_caches()
    spec = harness.cell_spec(args.workload)
    harness.pin_host()
    import torch

    chips = spec.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
