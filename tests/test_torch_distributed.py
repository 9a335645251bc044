"""The port's ``distributed-selftest`` as a real two-process job on the CPU.

Two OS processes join one ``torch.distributed`` job over a localhost TCP
rendezvous (the "gloo" backend, CPU tensors) and run the deterministic
workload of ``parallel/selftest.py``: 8 measurement-driven filter
sequences, 4 a rank, and the 40-keyframe ring solved by the Schur GN in 8
blocks, 4 a rank, the Schur systems and the metrics summed by
``all_reduce``. Both ranks must report the same checksums, equal to
float32 tolerance (1e-5 relative: the sums associate differently) to the
port's single-process run and to the JAX package's single-process
``run_selftest(8)`` on the conftest's 8 fake CPU devices.

Each worker is waited on with ``communicate(timeout=240)``, both killed on
a timeout; the rendezvous and every collective have their own timeout
(``parallel.mesh.INIT_TIMEOUT_S``, 120 s), so a lost peer fails the
worker, well inside that.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("filter_pos_checksum", "filter_cov_checksum", "pose_checksum")
RTOL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(args, out: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.Popen(
        [sys.executable, "-m", "cuahn_vio_torch.cli", "distributed-selftest", "--device", "cpu",
         "--out", out, *args],
        env=env, cwd=os.path.dirname(out), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
    )


def _wait(procs) -> list:
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        errs.append(err.decode(errors="replace"))
    for p, err in zip(procs, errs):
        assert p.returncode == 0, f"worker failed:\n{err[-2000:]}"
    return errs


def test_two_process_gloo_selftest_matches_one_process_and_jax(tmp_path):
    port = _free_port()
    outs = [str(tmp_path / f"p{i}.json") for i in range(2)]
    single = str(tmp_path / "single.json")
    procs = [_launch(["--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
                      "--process-id", str(i)], outs[i]) for i in range(2)]
    procs.append(_launch([], single))
    _wait(procs)
    results = [json.loads(open(o).read()) for o in outs]
    ref = json.loads(open(single).read())
    assert [r["n_processes"] for r in results] == [2, 2] and ref["n_processes"] == 1
    assert [r["process_id"] for r in results] == [0, 1]
    assert all(r["n_devices"] == 8 for r in results + [ref])
    for key in KEYS + ("pose_final_cost",):
        assert results[0][key] == results[1][key], key  # both ranks hold the reduced sums
    for key in KEYS:
        np.testing.assert_allclose(results[0][key], ref[key], rtol=RTOL, err_msg=key)

    if len(jax.devices()) < 8:
        pytest.fail("the conftest's 8 fake CPU devices are missing")
    from cuahn_vio.parallel.selftest import run_selftest

    jref = run_selftest(8)
    for key in KEYS:
        np.testing.assert_allclose(ref[key], jref[key], rtol=RTOL, err_msg=key)
    assert results[0]["pose_final_cost"] < 1e-6 and ref["pose_final_cost"] < 1e-6


def test_selftest_bench_runs_on_the_cpu():
    """The ``--bench`` workload at a small size, as one process: a rate
    and the replicated metric."""
    from cuahn_vio_torch.parallel.selftest import run_selftest_bench

    res = run_selftest_bench(2, device="cpu", frames=3, steps=2, reps=2)
    assert res["n_processes"] == 1 and res["bench_frames"] == 6
    assert res["bench_frames_per_s"] > 0 and np.isfinite(res["bench_metric_checksum"])
    assert len(res["bench_seconds_all"]) == 2
