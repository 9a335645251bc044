"""Streaming pose recorder and process resource monitor.

Counterpart of ``cuahn_vio.eval.recorder`` (numpy only, no torch).
``Recorder`` is ov_eval's Recorder/pose_to_file sink
(cuahn_ros/ov_eval/src/utils/Recorder.h:131-149): it appends 't x y z qx qy
qz qw [cov]' rows to a txt file as poses arrive, each flushed, so a long
run can be read while it writes and survives a crash with its rows. It
writes the JAX class's bytes.

``ResourceMonitor`` samples a process's CPU percent and resident memory
on a background thread (ov_eval/python/pid_sys.py semantics). The JAX
class reads them through psutil; here they come from ``/proc`` (Linux),
with psutil's arithmetic: CPU % is the change in the process's user +
system clock ticks (``/proc/<pid>/stat`` fields 14-15) over
``SC_CLK_TCK``, over the wall interval, times 100, the first sample only
priming it; RSS is ``/proc/<pid>/statm``'s resident pages times the page
size.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

import numpy as np


class Recorder:
    """Append-only pose txt writer in the evaluation-contract schema
    (Recorder.h:131: '# timestamp(s) tx ty tz qx qy qz qw [upper-tri
    covariance: 3x3 ori, 3x3 pos]')."""

    def __init__(self, path: str, write_cov: bool = False):
        self.path = path
        self.write_cov = write_cov
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "w")
        hdr = "# timestamp(s) tx ty tz qx qy qz qw"
        if write_cov:
            hdr += " Pr11 Pr12 Pr13 Pr22 Pr23 Pr33 Pt11 Pt12 Pt13 Pt22 Pt23 Pt33"
        self._f.write(hdr + "\n")
        self.count = 0

    def record(self, t: float, pose7: np.ndarray, cov_ori: Optional[np.ndarray] = None,
               cov_pos: Optional[np.ndarray] = None) -> None:
        """pose7 = [x y z qx qy qz qw]; covariances are 3x3 (their upper
        triangles are written, Recorder.h:140-148)."""
        vals = [t] + [float(v) for v in pose7]
        if self.write_cov:
            co = np.zeros((3, 3)) if cov_ori is None else np.asarray(cov_ori)
            cp = np.zeros((3, 3)) if cov_pos is None else np.asarray(cov_pos)
            for c in (co, cp):
                vals += [c[0, 0], c[0, 1], c[0, 2], c[1, 1], c[1, 2], c[2, 2]]
        self._f.write(" ".join(f"{v:.9f}" for v in vals) + "\n")
        self._f.flush()
        self.count += 1

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def cpu_ticks(stat_text: str) -> int:
    """utime + stime (clock ticks) of a ``/proc/<pid>/stat`` line. The
    command name, field 2, is in parentheses and may hold spaces, so the
    fields are counted from its closing parenthesis."""
    fields = stat_text[stat_text.rindex(")") + 2:].split()
    return int(fields[11]) + int(fields[12])  # fields 14 and 15 of the line


def cpu_percent(ticks0: int, ticks1: int, seconds: float, clk_tck: int) -> float:
    """psutil's ``cpu_percent``: CPU seconds used over wall seconds, in %."""
    if seconds <= 0.0:
        return 0.0
    return (ticks1 - ticks0) / clk_tck / seconds * 100.0


def rss_bytes(statm_text: str, page_size: int) -> int:
    """Resident set size of a ``/proc/<pid>/statm`` line."""
    return int(statm_text.split()[1]) * page_size


class ResourceMonitor:
    """Sample CPU percent and RSS of a process on a background thread
    (pid_sys.py:27-76 semantics, read from ``/proc``)."""

    def __init__(self, pid: Optional[int] = None, interval: float = 0.25):
        self.pid = os.getpid() if pid is None else int(pid)
        if not os.path.exists(f"/proc/{self.pid}/stat"):
            raise ProcessLookupError(f"no process {self.pid} in /proc")
        self.interval = interval
        self.clk_tck = os.sysconf("SC_CLK_TCK")
        self.page_size = os.sysconf("SC_PAGE_SIZE")
        self.cpu: list = []
        self.rss_mb: list = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _read(self, name: str) -> str:
        with open(f"/proc/{self.pid}/{name}") as f:
            return f.read()

    def _run(self):
        try:  # prime, as psutil's first cpu_percent call
            ticks, t = cpu_ticks(self._read("stat")), time.monotonic()
        except OSError:
            return
        while not self._stop.is_set():
            time.sleep(self.interval)
            try:
                ticks1, t1 = cpu_ticks(self._read("stat")), time.monotonic()
                rss = rss_bytes(self._read("statm"), self.page_size)
            except OSError:  # the process ended
                break
            self.cpu.append(cpu_percent(ticks, ticks1, t1 - t, self.clk_tck))
            self.rss_mb.append(rss / 1e6)
            ticks, t = ticks1, t1

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> dict:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval + 1.0)
        if not self.cpu:
            return {"samples": 0}
        return {
            "samples": len(self.cpu),
            "cpu_mean_pct": float(np.mean(self.cpu)),
            "cpu_max_pct": float(np.max(self.cpu)),
            "rss_mean_mb": float(np.mean(self.rss_mb)),
            "rss_max_mb": float(np.max(self.rss_mb)),
        }

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.summary = self.stop()
