"""Readings of the program's own spans in a traced window.

The program labels the stages of a network call with host spans
(``cuahn_vio_torch/utils/spans``: ``vio.uahn.call`` around the call and
``vio.uahn.prior``, ``block1``-``block4``, ``masks``, ``heads`` and
``transfer`` inside it). Each function here takes the run's ``Trace``
(``perfbench/lib/trace.py``) and a span name, and returns a number a span:
the sum over the window's spans of that name over their count. It returns
None where there is nothing to read: no trace, or no span of the name (a
program that has no such span). Only ``Trace``'s ``host_spans`` (name ->
[(start, end)] on the host), ``work`` (device activities (start, end,
name)) and ``launched`` (each device activity's (host time of its launch,
duration)) are read, all in ns of the profiler's clock. A span's device
time is ``readers.span_device_ms``'s.
"""

from __future__ import annotations

import bisect

from perfbench.lib.trace import _union


def _spans(trace, span: str):
    return None if trace is None else trace.host_spans.get(span) or None


def host_ms(trace, span: str):
    """Host ms from a span's start to its end (under the profiler, whose
    host overhead lengthens it: an upper bound for an untraced run)."""
    spans = _spans(trace, span)
    return None if spans is None else 1e3 * trace.host_s(span)[0] / len(spans)


def launches(trace, span: str):
    """Device activities (kernels, copies, memsets) launched inside a span."""
    spans = _spans(trace, span)
    if spans is None:
        return None
    starts = [t for t, _ in trace.launched]
    n = sum(bisect.bisect_right(starts, e) - bisect.bisect_left(starts, s) for s, e in spans)
    return n / len(spans)


def idle_ms(trace, span: str):
    """Ms of a span in which no device activity runs: its length less the
    part of it that the union of the device's activities covers, whoever
    launched them."""
    spans = _spans(trace, span)
    if spans is None:
        return None
    busy = _union(trace.work)
    ends = [e for _, e in busy]
    idle = 0
    for s, e in spans:
        covered = 0
        i = bisect.bisect_right(ends, s)  # the first busy interval that ends after s
        while i < len(busy) and busy[i][0] < e:
            covered += min(e, busy[i][1]) - max(s, busy[i][0])
            i += 1
        idle += (e - s) - covered
    return idle / len(spans) / 1e6
