"""Arithmetic that the metric readers share (``perfbench/metrics/``).

A reader returns None where its run has nothing to read: no trace, no
launch of its kernel, no peak for the card. A share is in per cent and is
never clipped: a share above 100 means the work is counted too high or
the time leaves some of it out.
"""

from __future__ import annotations


def rate(ctx, item: str):
    """Items of one kind over all the time of the window."""
    n = ctx.items.get(item)
    return None if n is None else n / ctx.window_s


def roofline(ctx, kernel: str, bound_s: float):
    """Per cent of the least time over the mean device time of one launch
    of the kernels whose name holds ``kernel``."""
    if ctx.trace is None:
        return None
    times = ctx.trace.kernels(kernel)
    if not times or bound_s is None:
        return None
    return 100.0 * bound_s / (sum(times) / len(times))


def mfu(ctx):
    """Per cent of the card's float32 peak that the model's FLOPs reach over
    the traced run's units timed with the profiler off (``ctx.untraced``:
    the profiler's host overhead slows a traced unit, not the work)."""
    flops = ctx.counts.get("flops_per_unit")
    if ctx.untraced is None or ctx.peaks is None or flops is None:
        return None
    units, seconds = ctx.untraced
    return 100.0 * flops * units / seconds / ctx.peaks["f32_flops"]


def idle_share(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)


def span_device_ms(ctx, span: str = "perfbench.unit"):
    """Device ms of the activities inside each ``span``, per span."""
    if ctx.trace is None:
        return None
    busy, n = ctx.trace.device_s_in(span)
    return None if n == 0 else 1e3 * busy / n
