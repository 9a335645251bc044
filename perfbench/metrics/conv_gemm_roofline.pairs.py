"""Kernel V2 (``conv_gemm.cu`` ``gemm_conv_kernel``, the fourteen tower
layers of blocks 2-4 that V1 leaves, with their bias and LeakyReLU): the
layers' float32 FLOP bound in one call (``gemm_counts.gemm_flops`` over the
card's float32 peak) over V2's device time in one call (all its launches
in the window over the window's ``vio.uahn.call`` spans). A program
without V2 has nothing to read."""
from perfbench.lib.gemm_counts import gemm_flops


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    times = ctx.trace.kernels("gemm_conv_kernel")
    _, calls = ctx.trace.host_s("vio.uahn.call")
    if not times or calls == 0:
        return None
    bound_s = gemm_flops(ctx.config, ctx.traffic["batch"]) / ctx.peaks["f32_flops"]
    return 100.0 * bound_s / (sum(times) / calls)
