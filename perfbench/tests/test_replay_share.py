"""``network_replay_share.pairs`` on hand-built traces: the share of the
program's ``vio.uahn.call`` spans that hold a ``vio.uahn.replay``."""

import os
from types import SimpleNamespace

import pytest

from perfbench.lib import harness
from perfbench.lib.trace import Trace

US = 1000  # the trace's clock is in ns; the times below are in us


class Event:
    def __init__(self, name, start_us, end_us, device="CPU"):
        self._name, self._s, self._e, self._device = name, start_us * US, end_us * US, device

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return f"DeviceType.{self._device}"

    def correlation_id(self):
        return 0


def read(events):
    reader = harness.load_file(
        os.path.join(harness.BENCH_DIR, "metrics", "network_replay_share.pairs.py"),
        "t_replay_share")
    trace = None if events is None else Trace(events, 0, 1000 * US)
    return reader.read(SimpleNamespace(trace=trace))


# four calls in a window of [0, 1000] us; the profiler's device-side
# mirror of a span is a span too, never a call of its own
CALLS = [Event("vio.uahn.call", 100 + 200 * i, 250 + 200 * i) for i in range(4)]
REPLAYS = [Event("vio.uahn.replay", 110 + 200 * i, 240 + 200 * i) for i in range(4)]
BASE = [Event("perfbench.window", 0, 1000), Event("vio.uahn.call", 120, 230, "CUDA")]


@pytest.mark.parametrize("replayed,share", [(0, 0.0), (1, 25.0), (3, 75.0), (4, 100.0)])
def test_share_of_calls_that_replay(replayed, share):
    # the first ``replayed`` calls hold a replay span, and a stray replay
    # span outside every call counts for none
    events = BASE + CALLS + REPLAYS[:replayed] + [Event("vio.uahn.replay", 900, 950)]
    assert read(events) == pytest.approx(share)


def test_nothing_to_read():
    assert read(None) is None
    assert read(BASE[:1] + REPLAYS) is None
