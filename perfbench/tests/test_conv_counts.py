"""The low-channel layers' count (``perfbench/lib/conv_counts.py``) against
arithmetic done by hand, and ``lowc_conv_roofline.pairs`` on a hand-built
trace: two calls, V1's three launches in each, one cuDNN kernel beside
them."""

import os
from types import SimpleNamespace

import pytest

from perfbench.lib import conv_counts, counts, harness
from perfbench.lib.trace import Trace

CONFIG = {"img_height": 224, "img_width": 320}


def test_layer_flops_by_hand():
    # 2 x output pixels x C_out x C_in k^2 on one pair
    assert conv_counts.layer_flops("block4", 0, 224, 320) == 2 * 224 * 320 * 8 * 2 * 49
    assert conv_counts.layer_flops("block4", 1, 224, 320) == 2 * 112 * 160 * 16 * 8 * 25
    assert conv_counts.layer_flops("block3", 0, 224, 320) == 2 * 112 * 160 * 16 * 2 * 49
    # stride 2 rounds up: 7 rows -> 4
    assert conv_counts.layer_flops("block4", 1, 7, 9) == 2 * 4 * 5 * 16 * 8 * 25
    with pytest.raises(ValueError):
        conv_counts.layer_flops("block4", 7, 224, 320)


def test_a_call_at_b64_and_the_towers_it_is_part_of():
    flops = conv_counts.lowc_flops(CONFIG, 64)
    assert flops == 64 * (2 * 224 * 320 * 8 * 2 * 49 + 2 * 112 * 160 * 16 * (8 * 25 + 2 * 49))
    assert flops == pytest.approx(18.13e9, rel=1e-3)
    assert flops / counts.PEAKS["NVIDIA H100 80GB HBM3"]["f32_flops"] == pytest.approx(
        0.2706e-3, rel=1e-3)
    # the layers are a part of their towers' count
    for block in ("block3", "block4"):
        layers = sum(conv_counts.layer_flops(block, i, 224, 320)
                     for i in range(len(conv_counts.TOWERS[block])))
        assert layers == counts.tower_flops(block, 224, 320)


US = 1000


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


def events(v1: bool):
    """Two calls; in each V1's three launches (50, 60 and 30 us) or,
    without V1, cuDNN's kernel in their place."""
    out = [Event("perfbench.window", 0, 1000)]
    corr = 0
    for start in (100, 500):
        out.append(Event("vio.uahn.call", start, start + 300))
        for i, (name, us) in enumerate((("lowc_conv_kernel<2, 16, 7, 1>", 30),
                                        ("lowc_conv_kernel<2, 8, 7, 1>", 50),
                                        ("lowc_conv_kernel<8, 16, 5, 2>", 60))):
            corr += 1
            at = start + 10 + 80 * i
            out.append(Event("cudaLaunchKernel", at, at + 5, corr=corr))
            kernel = f"void {name}(float const*)" if v1 else "void implicit_convolve_sgemm"
            out.append(Event(kernel, at + 10, at + 10 + us, device="CUDA", corr=corr))
    return out


def test_roofline_reader():
    reader = harness.load_file(
        os.path.join(harness.BENCH_DIR, "metrics", "lowc_conv_roofline.pairs.py"),
        "t_conv_lowc_conv_roofline")
    peaks = counts.PEAKS["NVIDIA H100 80GB HBM3"]
    ctx = SimpleNamespace(trace=Trace(events(True), 0, 1000 * US), peaks=peaks, config=CONFIG,
                          traffic={"batch": 64})
    bound_s = conv_counts.lowc_flops(CONFIG, 64) / peaks["f32_flops"]
    # V1's 140 us a call
    assert reader.read(ctx) == pytest.approx(100.0 * bound_s / 140e-6)
    # nothing to read: no trace, no peak for the card, or a program without V1
    assert reader.read(SimpleNamespace(**dict(vars(ctx), trace=None))) is None
    assert reader.read(SimpleNamespace(**dict(vars(ctx), peaks=None))) is None
    parent = SimpleNamespace(**dict(vars(ctx), trace=Trace(events(False), 0, 1000 * US)))
    assert reader.read(parent) is None
