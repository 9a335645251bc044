"""Device activities (kernels, copies, memsets) launched inside the
program's ``vio.uahn.call`` span, a call: what a graph replay of the call
would turn into one launch."""
from perfbench.lib.spans import launches


def read(ctx):
    return launches(ctx.trace, "vio.uahn.call")
