"""Host ms of a network call: the program's ``vio.uahn.call`` span, traced
(the dispatch that a graph of the call would take off the host; the
profiler lengthens it, so an upper bound)."""
from perfbench.lib.spans import host_ms


def read(ctx):
    return host_ms(ctx.trace, "vio.uahn.call")
