"""Device ms of a network call: the activities inside the benchmark's span
around each call of the traced window."""
from perfbench.lib.readers import span_device_ms


def read(ctx):
    return span_device_ms(ctx)
