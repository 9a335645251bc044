"""Kernel V1 (``conv.cu`` ``lowc_conv_kernel``, block 3's conv0 and block
4's conv0 and conv1 with their bias and LeakyReLU): the three layers'
float32 FLOP bound in one call (``conv_counts.lowc_flops`` over the card's
float32 peak; their bytes' bound is about half of it) over V1's device
time in one call (all its launches in the window over the window's
``vio.uahn.call`` spans). A program without V1 has nothing to read."""
from perfbench.lib.conv_counts import lowc_flops


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    times = ctx.trace.kernels("lowc_conv_kernel")
    _, calls = ctx.trace.host_s("vio.uahn.call")
    if not times or calls == 0:
        return None
    bound_s = lowc_flops(ctx.config, ctx.traffic["batch"]) / ctx.peaks["f32_flops"]
    return 100.0 * bound_s / (sum(times) / calls)
