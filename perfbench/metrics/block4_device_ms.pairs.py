"""Device ms of block 4 a call: the activities launched inside the
program's ``vio.uahn.block4`` span (the full-resolution warp and the
7-conv tower, cuDNN's float32 convolutions)."""
from perfbench.lib.readers import span_device_ms


def read(ctx):
    return span_device_ms(ctx, "vio.uahn.block4")
