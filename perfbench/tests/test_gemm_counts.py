"""The fourteen layers' count (``perfbench/lib/gemm_counts.py``) against
arithmetic done by hand, and ``conv_gemm_roofline.pairs`` on a hand-built
trace: two calls, V2's launches in each, V1's and cuDNN's kernels beside
them."""

import os
from types import SimpleNamespace

import pytest

from perfbench.lib import conv_counts, counts, gemm_counts, harness
from perfbench.lib.trace import Trace

CONFIG = {"img_height": 224, "img_width": 320}


def test_the_fourteen_layers():
    assert len(gemm_counts.GEMM_LAYERS) == 14
    assert not set(gemm_counts.GEMM_LAYERS) & set(conv_counts.LOWC_LAYERS)
    assert {b for b, _ in gemm_counts.GEMM_LAYERS} == {"block2", "block3", "block4"}


def test_a_call_at_b64_by_hand():
    # 2 x output pixels x C_out x C_in k^2, at 28x40, 14x20, 56x80, 7x10, 4x5
    by_hand = (2 * 28 * 40 * 64 * 2 * 49  # block2.conv0
               + 2 * 14 * 20 * 128 * 64 * 25  # block2.conv1
               + 2 * 56 * 80 * 32 * 16 * 25  # block3.conv1
               + 2 * 56 * 80 * 32 * 16 * 9  # block4.conv2
               + 2 * (2 * 28 * 40 * 64 * 32 * 9)  # block3.conv2, block4.conv3
               + 2 * (2 * 14 * 20 * 128 * 64 * 9)  # block3.conv3, block4.conv4
               + 3 * (2 * 7 * 10 * 256 * 128 * 9)  # block2.conv2, block3.conv4, block4.conv5
               + 3 * (2 * 4 * 5 * 256 * 256 * 9))  # block2.conv3, block3.conv5, block4.conv6
    flops = gemm_counts.gemm_flops(CONFIG, 64)
    assert flops == 64 * by_hand
    assert flops == pytest.approx(41.25e9, rel=1e-3)
    assert flops / counts.PEAKS["NVIDIA H100 80GB HBM3"]["f32_flops"] == pytest.approx(
        0.6157e-3, rel=1e-3)
    # with V1's three layers, the prior-mode cascade's towers whole
    lowc = conv_counts.lowc_flops(CONFIG, 64)
    towers = sum(counts.tower_flops(b, 224, 320) for b in counts.CASCADES["prior3"])
    assert flops + lowc == 64 * towers


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


def events(v2: bool):
    """Two calls; in each a V1 launch (20 us) and two V2 launches (40 and
    60 us) or, without V2, cuDNN's kernel in their place."""
    out = [Event("perfbench.window", 0, 1000)]
    corr = 0
    for start in (100, 500):
        out.append(Event("vio.uahn.call", start, start + 300))
        for i, (name, us) in enumerate((("lowc_conv_kernel<2, 16, 7, 1>", 20),
                                        ("gemm_conv_kernel<2, 64, 7, 2>", 40),
                                        ("gemm_conv_kernel<256, 256, 3, 2>", 60))):
            corr += 1
            at = start + 10 + 80 * i
            out.append(Event("cudaLaunchKernel", at, at + 5, corr=corr))
            if i and not v2:
                name = "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw"
            kernel = f"void (anonymous namespace)::{name}(float const*)"
            out.append(Event(kernel, at + 10, at + 10 + us, device="CUDA", corr=corr))
    return out


def test_roofline_reader():
    reader = harness.load_file(
        os.path.join(harness.BENCH_DIR, "metrics", "conv_gemm_roofline.pairs.py"),
        "t_gemm_conv_gemm_roofline")
    peaks = counts.PEAKS["NVIDIA H100 80GB HBM3"]
    ctx = SimpleNamespace(trace=Trace(events(True), 0, 1000 * US), peaks=peaks, config=CONFIG,
                          traffic={"batch": 64})
    bound_s = gemm_counts.gemm_flops(CONFIG, 64) / peaks["f32_flops"]
    # V2's 100 us a call; V1's kernel is not V2's
    assert reader.read(ctx) == pytest.approx(100.0 * bound_s / 100e-6)
    # nothing to read: no trace, no peak for the card, or a program without V2
    assert reader.read(SimpleNamespace(**dict(vars(ctx), trace=None))) is None
    assert reader.read(SimpleNamespace(**dict(vars(ctx), peaks=None))) is None
    parent = SimpleNamespace(**dict(vars(ctx), trace=Trace(events(False), 0, 1000 * US)))
    assert reader.read(parent) is None
