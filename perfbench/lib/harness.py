"""One run of one cell: set-up, the measured (or traced) window, the check.

Everything that belongs to a configuration, a traffic mix, a metric or a
cell's limits is found by name in files of its own:

- ``BENCHMARK.json`` (the repository root): cells, metrics, run length;
- ``perfbench/configs/<config>.json``: the configuration as it is run;
- ``perfbench/traffic/<traffic>.json``: the mix, whose ``work`` names
  ``perfbench/work/<work>.py`` (its class ``Work``);
- ``perfbench/metrics/<metric>.py``: one reader a metric, ``read(ctx)``
  -> a number, or None where the run has nothing to read;
- ``perfbench/limits/<cell>.json``: the limit of each number the cell's
  check compares.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cuahn_vio")
HOST_CPUS = 2  # the cores a run holds to (``pin_host``)


def read_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_spec(workload: str) -> SimpleNamespace:
    """The cell's entry, configuration, traffic, limits and metrics."""
    bench = read_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(ROOT, configs[cell["config"]]["file"])
    traffic = read_json(BENCH_DIR, "traffic", f"{cell['traffic']}.json")
    limits = read_json(BENCH_DIR, "limits", f"{workload}.json")

    def mine(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if mine(m) and ("workloads" in m or m["moves"] in names)]
    return SimpleNamespace(bench=bench, cell=cell, config=config, traffic=traffic,
                           limits=limits, end_to_end=e2e, per_layer=layer)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def pin_host(cpus: int = HOST_CPUS) -> None:
    """Hold the process to ``cpus`` fixed cores (the highest-numbered of
    those it may use, away from cpu 0's interrupts), with as many threads
    for the CPU's math libraries. Set before torch is imported. A rate that
    the host's dispatch paces then moves less from one process to the next."""
    allowed = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, allowed[-cpus:])
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(min(cpus, len(allowed)))


def use_checkout_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own nvcc cache is ``cuahn_vio_torch/_build/``)."""
    cache = os.path.join(ROOT, ".perfbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)


def device_info(torch) -> dict:
    import subprocess

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}
    try:
        info["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        info["power_limit"] = "unknown"
    return info


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", traffic_overrides: dict | None = None,
        model_factory=None) -> dict:
    """One run; returns the result line's object. ``device="cpu"`` (tests
    only) skips the look for a card, reads no device trace and reports
    no device metric; ``traffic_overrides`` (tests only) shrink the traffic."""
    import torch

    spec = cell_spec(workload)
    traffic = dict(spec.traffic, **(traffic_overrides or {}))
    work_mod = load_file(os.path.join(BENCH_DIR, "work", f"{traffic['work']}.py"),
                        f"perfbench_work_{traffic['work']}")
    on_card = device != "cpu"
    work = work_mod.Work(spec.config, traffic, seed, device, model_factory=model_factory)
    work.setup()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        units = traffic["trace_units"]
        sync()
        t_u = time.perf_counter()
        for u in range(units):  # the same units untraced, for the rates
            work.unit(u)
        sync()
        untraced = (units, time.perf_counter() - t_u)
        t0 = time.perf_counter()
        with profile(activities=activities) as prof:
            with record_function("perfbench.window"):
                for u in range(units):
                    with record_function("perfbench.unit"):
                        work.unit(u)
                sync()
        sync()
        window_s = time.perf_counter() - t0
    else:
        untraced = None
        sync()
        t0 = time.perf_counter()
        units = 0
        while True:
            work.unit(units)
            units += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    ctx = SimpleNamespace(setup_s=setup_s, window_s=window_s, units=units, untraced=untraced,
                          items=work.items(units), counts=work.counts(),
                          config=spec.config, traffic=traffic, trace=None, peaks=None)
    device_out = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    breakdown = None
    if on_card:
        from perfbench.lib.counts import PEAKS

        device_out = dict(device_info(torch), memory_peak_bytes=int(peak))
        ctx.peaks = PEAKS.get(device_out["kind"])
    if prof is not None:
        from perfbench.lib.trace import Trace

        ctx.trace = Trace.of_window(prof.profiler.kineto_results.events(), "perfbench.window")
        ctx.window_s = ctx.trace.window_s
        if on_card:
            device_out["busy_s"] = ctx.trace.busy_s()
            device_out["window_s"] = ctx.trace.window_s
            breakdown = ctx.trace.breakdown()
        del prof

    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        reader = load_file(os.path.join(BENCH_DIR, "metrics", f"{m['name']}.py"),
                           "perfbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(ctx) if (on_card or m.get("source") != "device_trace") else None
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    work.release()
    if on_card:
        torch.cuda.empty_cache()
    readings, attempted, failed = work.check()
    checks = {k: {"value": v, "limit": spec.limits[k]} for k, v in readings.items()}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_out}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
