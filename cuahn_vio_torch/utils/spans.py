"""Named spans on the profiler's host timeline, free when no profiler runs.

``with span("vio.uahn.block4"): ...`` is ``torch.profiler.record_function``
while a profiler (``torch.profiler.profile`` or the autograd profiler) is
recording, and one shared do-nothing context otherwise. ``record_function``
enters a dispatcher op even with no profiler (~11-13 us a span on a CPU);
the flag that ``span`` reads instead costs well under a microsecond, so the
port's spans can sit inside the network call that ``close-loops`` and the
estimator run at every frame.

A span adds no device work, no synchronize and no host read: outputs are
the same with a profiler on or off. Under ``torch.profiler`` with CUDA
activity, the profiler mirrors each span onto the device timeline and
matches the kernels launched inside it by correlation id, so a trace can
put the device's work and its idle gaps down to the stage the host was in.

Span names start with ``vio.`` (the estimator's stages and the network's,
``vio.uahn.*``) or ``track.`` (the feature tracker): the prefixes that
``profile_slice.py`` groups by and the benchmark reads as spans, not as
device work.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that labels its body ``name`` in a profiler's
    trace; a shared no-op (no allocation) when no profiler records."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF
