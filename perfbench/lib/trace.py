"""Reduction of a ``torch.profiler`` trace to what the metric readers read.

The arithmetic is a frozen copy of ``profile_slice.py``'s: the device is
busy where a device activity (kernel, copy, memset) runs; an annotation
span that the profiler mirrors onto the device timeline is a span, not
work; a span's device time is the device activity that starts inside it.
Here busy time is the union of the activities' intervals (one stream
today, so the union is their sum), a span's device time is that of the
activities launched inside its host span (by the profiler's correlation
ids: the device-side mirror of a span missed half of a call's kernels on
the card), and the reading goes through the profiler's raw events
(``kineto_results.events()``), which costs a fraction of building
``prof.events()``.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

# host annotation spans: the benchmark's own, the program's stage labels
# and the profiler's step markers; mirrored onto the device timeline, they
# are spans there too, not work
SPAN_PREFIXES = ("perfbench.", "vio.", "train.", "fil.", "track.", "ProfilerStep#")


def _start_end(e) -> tuple[int, int]:
    if hasattr(e, "start_ns"):
        s = e.start_ns()
        return s, s + e.duration_ns()
    s = int(e.start_us() * 1000)
    return s, s + int(e.duration_us() * 1000)


def _on_device(e) -> bool:
    return "CUDA" in str(e.device_type())


class Trace:
    """Device activities, host spans and ops of one profiled window
    [t0_ns, t1_ns] (host clock, the profiler's timebase)."""

    def __init__(self, events, t0_ns: int, t1_ns: int):
        self.t0, self.t1 = t0_ns, t1_ns
        self.work = []  # (start, end, name)
        self.host_spans = defaultdict(list)  # name -> [(start, end)]
        self.host_ops = []  # (start, end, name) of every host op and span
        launches = {}  # correlation id -> host time of the launching runtime call
        device = []
        for e in events:
            name = e.name()
            s, end = _start_end(e)
            span = name.startswith(SPAN_PREFIXES)
            if _on_device(e):
                if not span:
                    device.append((s, end, name, e.correlation_id()))
            elif span:
                self.host_spans[name].append((s, end))
                self.host_ops.append((s, end, name))
            elif name.startswith("cu"):  # a CUDA API call (a launch, a copy)
                launches[e.correlation_id()] = s
            else:
                self.host_ops.append((s, end, name))
        self.work = [(s, e, n) for s, e, n, _ in device]
        # each device activity at the host time of its launch
        self.launched = sorted((launches[c], e - s) for s, e, _, c in device if c in launches)
        self.work.sort()
        self.host_ops.sort()
        self._busy = _union(self.work)

    @classmethod
    def of_window(cls, events, span: str) -> "Trace":
        """The trace of the window that the host spans named ``span`` (or
        starting so, for the profiler's ``ProfilerStep#``) cover."""
        events = list(events)
        win = [_start_end(e) for e in events if e.name().startswith(span) and not _on_device(e)]
        if not win:
            raise RuntimeError(f"no host span {span!r} in the trace")
        return cls(events, min(w[0] for w in win), max(w[1] for w in win))

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_s(self) -> float:
        """Seconds of the window in which some device activity ran."""
        return sum(min(e, self.t1) - max(s, self.t0) for s, e in self._busy
                   if e > self.t0 and s < self.t1) / 1e9

    def kernels(self, substring: str) -> list:
        """Durations (s) of the device activities whose name holds
        ``substring``."""
        return [(e - s) / 1e9 for s, e, n in self.work if substring in n]

    def device_s_in(self, span: str) -> tuple[float, int]:
        """(device seconds of the activities launched inside each host
        ``span``, matched by the profiler's correlation ids, number of
        spans)."""
        spans = self.host_spans.get(span, [])
        starts = [t for t, _ in self.launched]
        total = 0
        for s, e in spans:
            lo, hi = bisect.bisect_left(starts, s), bisect.bisect_right(starts, e)
            total += sum(d for _, d in self.launched[lo:hi])
        return total / 1e9, len(spans)

    def host_s(self, span: str) -> tuple[float, int]:
        """(host seconds inside the host-side ``span``, number of spans)."""
        spans = self.host_spans.get(span, [])
        return sum(e - s for s, e in spans) / 1e9, len(spans)

    def breakdown(self, n: int = 10) -> dict:
        """The device operations with the most time, and the idle gaps
        summed by what the host was doing when each began: the innermost
        host op or span running then (``host idle`` where none was)."""
        by_name = defaultdict(float)
        for s, e, name in self.work:
            by_name[name] += (e - s) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = defaultdict(float)
        starts = [o[0] for o in self.host_ops]
        prev = self.t0
        for s, e in self._busy + [(self.t1, self.t1)]:
            if s > prev:
                gaps[self._host_at(prev, starts)] += (min(s, self.t1) - prev) / 1e9
            prev = max(prev, e)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[k[:120], v] for k, v in idle]}

    def _host_at(self, t: int, starts: list) -> str:
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - 400, -1), -1):
            s, e, name = self.host_ops[j]
            if e >= t:
                return name
        return "host idle"


def _union(intervals) -> list:
    out = []
    for s, e, _ in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]
