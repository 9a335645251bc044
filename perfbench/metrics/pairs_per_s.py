"""Frame pairs through the network over all the time of the window."""
from perfbench.lib.readers import rate


def read(ctx):
    return rate(ctx, "pairs")
