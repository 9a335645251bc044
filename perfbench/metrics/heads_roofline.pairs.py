"""Kernel pair H1 (``heads.cu``: ``mc_heads_gemm_kernel``, fc0 of both
MC-dropout heads split over K, and ``mc_heads_tail_kernel``, the rest of
each member and the ensemble statistics): the two 16-member heads' float32
FLOP bound in one call (``counts.head_flops`` a pair times the traffic's
batch, over the card's float32 peak) over H1's device time in one call
(all its launches in the window over the window's ``vio.uahn.call``
spans). A program without H1 has nothing to read."""
from perfbench.lib.counts import head_flops


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    times = ctx.trace.kernels("mc_heads_")
    _, calls = ctx.trace.host_s("vio.uahn.call")
    if not times or calls == 0:
        return None
    flops = head_flops(ctx.config["img_height"], ctx.config["img_width"]) * ctx.traffic["batch"]
    return 100.0 * flops / ctx.peaks["f32_flops"] / (sum(times) / calls)
