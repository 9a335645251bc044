"""Ms of a network call in which the device runs nothing: the program's
``vio.uahn.call`` span less the part of it that device activity covers.
The window's other idle time lies between calls, in the harness."""
from perfbench.lib.spans import idle_ms


def read(ctx):
    return idle_ms(ctx.trace, "vio.uahn.call")
