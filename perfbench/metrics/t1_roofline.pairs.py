"""Kernel T1 (``prng.cu`` ``threefry_kernel``, a call's Bernoulli masks):
the function's bound (``counts.t1_bound_s``) over its mean device time a
launch."""
from perfbench.lib.counts import t1_bound_s
from perfbench.lib.readers import roofline


def read(ctx):
    if ctx.peaks is None or "t1_values" not in ctx.counts:
        return None
    return roofline(ctx, "threefry_kernel", t1_bound_s("bernoulli", ctx.counts["t1_values"],
                                                       ctx.peaks))
