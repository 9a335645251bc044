"""The calls' model FLOPs (``counts.uahn_flops``: the towers that ran and
the 16-member heads) over the traced window, against the card's float32
peak."""
from perfbench.lib.readers import mfu


def read(ctx):
    return mfu(ctx)
