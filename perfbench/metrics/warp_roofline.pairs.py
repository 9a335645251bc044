"""Kernel B2 (``warp.cu`` ``warp_kernel``, uint8 at the call's batch): its
byte bound (``counts.warp_bytes``) over its mean device time a launch."""
from perfbench.lib.readers import roofline


def read(ctx):
    if ctx.peaks is None or "warp_bytes" not in ctx.counts:
        return None
    return roofline(ctx, "warp_kernel", ctx.counts["warp_bytes"] / ctx.peaks["hbm_bytes"])
