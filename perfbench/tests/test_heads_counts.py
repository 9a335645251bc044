"""The two heads' count (``perfbench/lib/counts.head_flops``) against
arithmetic done by hand, and ``heads_roofline.pairs`` on a hand-built
trace: two calls, H1's two launches in each, V2's and cuBLAS's kernels
beside them."""

import os
from types import SimpleNamespace

import pytest

from perfbench.lib import counts, harness
from perfbench.lib.trace import Trace
from perfbench.tests.test_gemm_counts import CONFIG, US, Event


def test_the_heads_at_b64_by_hand():
    # 2 heads x 16 members x 2 x (fc0 5120 -> 256 + fc1 256 -> 8), 5120 = 256 x 4 x 5
    by_hand = 2 * 16 * 2 * (256 * 4 * 5 * 256 + 256 * 8)
    assert counts.head_flops(224, 320) == by_hand
    flops = 64 * by_hand
    assert flops == pytest.approx(5.377e9, rel=1e-3)
    assert flops / counts.PEAKS["NVIDIA H100 80GB HBM3"]["f32_flops"] == pytest.approx(
        0.08025e-3, rel=1e-3)


def events(h1: bool):
    """Two calls; in each a V2 launch (40 us) and H1's two launches (70 and
    10 us) or, without H1, two cuBLAS sgemms and an elementwise kernel in
    their place."""
    out = [Event("perfbench.window", 0, 1000)]
    corr = 0
    for start in (100, 500):
        out.append(Event("vio.uahn.call", start, start + 300))
        kernels = [("gemm_conv_kernel<256, 256, 3, 2, false>", 40)]
        if h1:
            kernels += [("mc_heads_gemm_kernel<128, 128, 8, 8>", 70), ("mc_heads_tail_kernel", 10)]
        else:
            kernels += [("cutlass_80_simt_sgemm_128x64_8x5_tn_align1", 30)] * 2 + [
                ("at::native::elementwise_kernel<128, 2>", 20)]
        for i, (name, us) in enumerate(kernels):
            corr += 1
            at = start + 10 + 60 * i
            out.append(Event("cudaLaunchKernel", at, at + 5, corr=corr))
            out.append(Event(f"void (anonymous namespace)::{name}(float const*)", at + 10,
                             at + 10 + us, device="CUDA", corr=corr))
    return out


def test_roofline_reader():
    reader = harness.load_file(
        os.path.join(harness.BENCH_DIR, "metrics", "heads_roofline.pairs.py"),
        "t_heads_roofline")
    peaks = counts.PEAKS["NVIDIA H100 80GB HBM3"]
    ctx = SimpleNamespace(trace=Trace(events(True), 0, 1000 * US), peaks=peaks, config=CONFIG,
                          traffic={"batch": 64})
    bound_s = 64 * counts.head_flops(224, 320) / peaks["f32_flops"]
    # H1's 80 us a call; V2's kernel is not H1's
    assert reader.read(ctx) == pytest.approx(100.0 * bound_s / 80e-6)
    # nothing to read: no trace, no peak for the card, or a program without H1
    assert reader.read(SimpleNamespace(**dict(vars(ctx), trace=None))) is None
    assert reader.read(SimpleNamespace(**dict(vars(ctx), peaks=None))) is None
    parent = SimpleNamespace(**dict(vars(ctx), trace=Trace(events(False), 0, 1000 * US)))
    assert reader.read(parent) is None
