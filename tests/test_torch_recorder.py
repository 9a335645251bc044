"""The port's pose recorder and resource monitor (``eval/recorder.py``)
against the JAX package's, on the CPU.

- ``Recorder`` writes the JAX ``Recorder``'s bytes, with and without the
  covariance columns.
- The CPU percent is psutil's formula on ``/proc/<pid>/stat`` ticks: two
  fixed snapshots give the value worked out by hand (exact), the command
  name may hold spaces and parentheses.
- RSS from ``/proc/<pid>/statm`` is within 5 % of psutil's
  ``memory_info().rss`` of the same process, read back to back.
- ``pid-monitor`` prints one JSON line with the JAX verb's keys, sampling
  a child process.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np

from cuahn_vio import cli as jcli
from cuahn_vio.eval.recorder import Recorder as JaxRecorder
from cuahn_vio_torch import cli as tcli
from cuahn_vio_torch.eval import recorder as trec


def _record(cls, path, write_cov):
    rng = np.random.default_rng(3)
    with cls(path, write_cov=write_cov) as rec:
        for k in range(5):
            pose = np.concatenate([rng.normal(size=3), rng.normal(size=4)])
            cov = rng.normal(size=(2, 3, 3))
            rec.record(1000.0 + 0.05 * k, pose, *(cov if k % 2 else (None, cov[1])))
        assert rec.count == 5


def test_recorder_writes_the_jax_recorders_bytes(tmp_path):
    for write_cov in (False, True):
        paths = [str(tmp_path / "sub" / f"{name}_{write_cov}.txt") for name in ("jax", "port")]
        _record(JaxRecorder, paths[0], write_cov)
        _record(trec.Recorder, paths[1], write_cov)
        with open(paths[0], "rb") as f0, open(paths[1], "rb") as f1:
            assert f1.read() == f0.read()


STAT0 = ("4242 (python3 (my worker) x) S 1 4242 4242 0 -1 4194560 5000 0 0 0 "
         "150 50 0 0 20 0 3 0 900 1000000 2000 18446744073709551615")
STAT1 = ("4242 (python3 (my worker) x) R 1 4242 4242 0 -1 4194560 5100 0 0 0 "
         "230 70 0 0 20 0 3 0 900 1000000 2100 18446744073709551615")


def test_cpu_percent_is_psutils_formula_on_proc_ticks():
    assert trec.cpu_ticks(STAT0) == 200 and trec.cpu_ticks(STAT1) == 300
    # 100 ticks at 100 Hz = 1 CPU second over 2 wall seconds
    assert trec.cpu_percent(200, 300, 2.0, 100) == 50.0
    assert trec.cpu_percent(200, 200, 0.0, 100) == 0.0
    assert trec.rss_bytes("12345 678 90 1 0 2 0", 4096) == 678 * 4096


def test_rss_follows_psutil_in_this_process():
    import psutil

    ballast = np.ones(20_000_000 // 8)  # a resident 20 MB to read
    with open(f"/proc/{os.getpid()}/statm") as f:
        ours = trec.rss_bytes(f.read(), os.sysconf("SC_PAGE_SIZE"))
    theirs = psutil.Process().memory_info().rss
    assert abs(ours - theirs) <= 0.05 * theirs, (ours, theirs)
    assert ballast.sum() > 0


def test_pid_monitor_prints_the_jax_verbs_keys():
    child = subprocess.Popen([sys.executable, "-c",
                              "import time\nt = time.time()\nwhile time.time() - t < 30: pass"])
    try:
        said = {}
        for package, main in (("jax", jcli.main), ("port", tcli.main)):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                main(["pid-monitor", str(child.pid), "--duration", "0.8", "--interval", "0.2"])
            lines = out.getvalue().splitlines()
            assert len(lines) == 1
            said[package] = json.loads(lines[0])
    finally:
        child.kill()
        child.wait()
    assert set(said["port"]) == set(said["jax"]) == {
        "samples", "cpu_mean_pct", "cpu_max_pct", "rss_mean_mb", "rss_max_mb"}
    assert said["port"]["samples"] >= 2
    assert said["port"]["cpu_max_pct"] > 10.0  # the child spins
    assert said["port"]["rss_max_mb"] > 1.0


def test_monitor_stops_when_its_process_is_gone():
    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(30)"])
    mon = trec.ResourceMonitor(child.pid, interval=0.05).start()
    child.kill()
    child.wait()
    mon._thread.join(timeout=5.0)
    assert not mon._thread.is_alive()  # the sampler ended with the process
    assert set(mon.stop()) <= {"samples", "cpu_mean_pct", "cpu_max_pct", "rss_mean_mb",
                               "rss_max_mb"}
