"""The readers of the program's spans (``perfbench/lib/spans.py`` and the
four metrics that use it) on a hand-built trace, against arithmetic done
by hand: two network calls, a gap inside one, a kernel launched inside
block 4 that runs after the span ends, and a copy counted as a launch."""

import os
from types import SimpleNamespace

import pytest

from perfbench.lib import harness, spans
from perfbench.lib.readers import span_device_ms
from perfbench.lib.trace import Trace

US = 1000  # the trace's clock is in ns; the times below are in us


class Event:
    def __init__(self, name, start_us, end_us, device="CPU", corr=0):
        self._name, self._s, self._e = name, start_us * US, end_us * US
        self._device, self._corr = device, corr

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return f"DeviceType.{self._device}"

    def correlation_id(self):
        return self._corr


def launch(at_us, corr, name="cudaLaunchKernel"):
    return Event(name, at_us, at_us + 5, corr=corr)


def on_card(name, start_us, end_us, corr):
    return Event(name, start_us, end_us, device="CUDA", corr=corr)


# window [0, 1000] us; call 1 [100, 400] with block 4 [200, 300], call 2
# [600, 800] with block 4 [650, 700]. Device work: [60, 90] launched
# before any call; [160, 220] from call 1; [280, 450] launched in call 1's
# block 4, running past both its block 4 and the call; a copy [450, 470]
# launched in that block 4 too; [670, 690] from call 2's block 4. The
# profiler's device-side mirror of call 1 is a span, not work.
EVENTS = [
    Event("perfbench.window", 0, 1000),
    launch(50, 5), on_card("void gemm_kernel", 60, 90, 5),
    Event("vio.uahn.call", 100, 400),
    launch(150, 1), on_card("void conv_kernel", 160, 220, 1),
    Event("aten::conv2d", 140, 190),
    Event("vio.uahn.block4", 200, 300),
    launch(250, 2), on_card("void implicit_convolve_sgemm", 280, 450, 2),
    launch(290, 3, "cudaMemcpyAsync"), on_card("Memcpy DtoD (Device -> Device)", 450, 470, 3),
    on_card("vio.uahn.call", 160, 470, 0),
    Event("vio.uahn.call", 600, 800),
    Event("vio.uahn.block4", 650, 700),
    launch(660, 4), on_card("void conv_kernel", 670, 690, 4),
]


@pytest.fixture
def trace():
    return Trace(EVENTS, 0, 1000 * US)


def test_host_ms(trace):
    assert spans.host_ms(trace, "vio.uahn.call") == pytest.approx((300 + 200) / 2 / 1e3)


def test_launches_count_kernels_and_copies(trace):
    # call 1 launches two kernels and a copy, call 2 one kernel
    assert spans.launches(trace, "vio.uahn.call") == (3 + 1) / 2
    assert spans.launches(trace, "vio.uahn.block4") == (2 + 1) / 2


def test_device_ms_follows_the_launch(trace):
    # block 4's kernel runs 170 us, mostly after its span, and the copy 20
    # us after that: both are block 4's; call 2's block 4 launches 20 us
    ctx = SimpleNamespace(trace=trace)
    assert span_device_ms(ctx, "vio.uahn.block4") == pytest.approx((170 + 20 + 20) / 2 / 1e3)
    assert span_device_ms(ctx, "vio.uahn.call") == pytest.approx((60 + 170 + 20 + 20) / 2 / 1e3)


def test_idle_ms_and_the_window(trace):
    # busy [60, 90], [160, 220], [280, 470], [670, 690]; call 1 [100, 400]
    # is covered 60 + 120 us, call 2 [600, 800] 20 us
    idle = spans.idle_ms(trace, "vio.uahn.call")
    assert idle == pytest.approx(((300 - 180) + (200 - 20)) / 2 / 1e3)
    # the calls' idle and the idle outside them (70 + 130 + 200 us) make
    # the window's
    window_idle_ms = (trace.window_s - trace.busy_s()) * 1e3
    assert window_idle_ms == pytest.approx(0.700)
    assert idle * 2 + (70 + 130 + 200) / 1e3 == pytest.approx(window_idle_ms)


def test_breakdown_names_the_stage(trace):
    """An idle gap that opens while the host is inside a span is put down
    to the innermost span or op then running."""
    gaps = dict(trace.breakdown()["idle_gaps"])
    # [220, 280) opens inside call 1's block 4, [690, 1000) inside call
    # 2's; [0, 60), [90, 160) and [470, 670) inside the window's span alone
    assert gaps == pytest.approx({"vio.uahn.block4": (60 + 310) / 1e6,
                                  "perfbench.window": (60 + 70 + 200) / 1e6})


@pytest.mark.parametrize("name,value", [
    ("network_host_ms.pairs", 0.25),
    ("network_idle_ms.pairs", 0.15),
    ("network_launches.pairs", 2.0),
    ("block4_device_ms.pairs", 0.105),
])
def test_metric_readers(trace, name, value):
    reader = harness.load_file(os.path.join(harness.BENCH_DIR, "metrics", f"{name}.py"),
                               "t_spans_" + name.replace(".", "_"))
    assert reader.read(SimpleNamespace(trace=trace)) == pytest.approx(value)
    # nothing to read: no trace, or a program without the spans
    assert reader.read(SimpleNamespace(trace=None)) is None
    bare = Trace([e for e in EVENTS if not e.name().startswith("vio.")], 0, 1000 * US)
    assert reader.read(SimpleNamespace(trace=bare)) is None
