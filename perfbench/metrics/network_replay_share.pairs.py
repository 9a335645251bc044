"""Per cent of the traced window's network calls (the program's
``vio.uahn.call`` spans) that were replayed from CUDA graphs: that hold
a ``vio.uahn.replay`` span. None without a trace or without a call; 0
where the program replays nothing."""
import bisect


def read(ctx):
    trace = ctx.trace
    calls = None if trace is None else trace.host_spans.get("vio.uahn.call")
    if not calls:
        return None
    replays = sorted(trace.host_spans.get("vio.uahn.replay", []))
    starts = [s for s, _ in replays]
    held = 0
    for s, e in calls:
        i = bisect.bisect_left(starts, s)
        held += i < len(replays) and replays[i][1] <= e
    return 100.0 * held / len(calls)
