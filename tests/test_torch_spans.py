"""The port's spans (``cuahn_vio_torch/utils/spans``) on the CPU.

Under ``torch.profiler`` a network call emits its ``vio.uahn.*`` stages,
each inside ``vio.uahn.call``, and the estimator's stages still emit
``vio.propagate``, ``vio.network`` and ``vio.update``; with no profiler
``span`` never enters ``record_function``; the outputs do not depend on
whether a profiler records; and every span name the port uses starts
with a prefix that the benchmark's trace reads as a span
(``perfbench/lib/trace.SPAN_PREFIXES``)."""

import os
import re
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cuahn_vio_torch.filter.state import FilterState
from cuahn_vio_torch.models.uahn import build_uahn
from cuahn_vio_torch.pipeline.vio import make_vio_stages
from cuahn_vio_torch.utils import prng, spans
from cuahn_vio_torch.utils.config import VioOptions
from perfbench.lib.trace import SPAN_PREFIXES

torch.set_num_threads(2)

H, W, B = 32, 48, 2  # a tiny frame: fc_input 256 x 1 x 1
PACKAGE = os.path.join(os.path.dirname(__file__), "..", "cuahn_vio_torch")

# each stage's spans a call, by cascade
PRIOR = {"vio.uahn.call": 1, "vio.uahn.prior": 1, "vio.uahn.block2": 1, "vio.uahn.block3": 1,
         "vio.uahn.masks": 1, "vio.uahn.block4": 1, "vio.uahn.heads": 1, "vio.uahn.transfer": 1}
FULL = {"vio.uahn.call": 1, "vio.uahn.block1": 1, "vio.uahn.block2": 1, "vio.uahn.block3": 1,
        "vio.uahn.masks": 1, "vio.uahn.block4": 1, "vio.uahn.heads": 1, "vio.uahn.transfer": 1}


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return build_uahn(None, device="cpu", dropout_rate=0.05, img_height=H, img_width=W)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(21)
    img1 = torch.as_tensor(rng.integers(0, 256, (B, H, W), dtype=np.uint8))
    img2 = torch.as_tensor(rng.integers(0, 256, (B, H, W), dtype=np.uint8))
    prior = torch.as_tensor(rng.normal(0, 1.5, (B, 4, 2)).astype(np.float32))
    keys = prng.keys_tensor(prng.mask_keys(prng.fold_in(prng.prng_key(7), np.arange(B))))
    return img1, img2, prior, keys


def _call(model, inputs, use_prior: bool, error_map: bool = False):
    img1, img2, prior, keys = inputs
    return model(img1, img2, prior if use_prior else None, use_prior=use_prior,
                 dropout_keys=keys, return_error_map=error_map)


def _spans(prof, prefix: str) -> list:
    """(name, start, end) of the host spans whose name starts with prefix."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith(prefix) and e.device_type == torch.autograd.DeviceType.CPU]


@pytest.mark.parametrize("use_prior,error_map,expected", [
    (True, False, PRIOR),
    (False, True, FULL),
], ids=["prior", "full-cascade"])
def test_network_call_emits_its_stages(model, inputs, use_prior, error_map, expected):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _call(model, inputs, use_prior, error_map)
    found = _spans(prof, "vio.uahn.")
    assert Counter(name for name, _, _ in found) == expected
    (_, s0, e0), = [f for f in found if f[0] == "vio.uahn.call"]
    for name, s, e in found:
        assert s0 <= s <= e <= e0, name


def _tiny_state() -> FilterState:
    z3 = torch.zeros(3)
    return FilterState(p=torch.tensor([0.0, 0.0, -1.5]), q=torch.tensor([1.0, 0.0, 0.0, 0.0]),
                       v=z3, ba=z3, bg=z3, off=torch.zeros(4, 3), cov=1e-3 * torch.eye(27))


def _run_stages(model, inputs):
    """Each stage of the estimator's step once on tiny inputs."""
    opts = VioOptions.uzhfpv_indoor45()
    stages = make_vio_stages(model, opts.filter_params("cpu"), opts.vio_config())
    img1, img2, _, keys = inputs
    t = 8
    w = torch.zeros(t, 3)
    a = torch.tensor([0.0, 0.0, 9.81]).expand(t, 3).contiguous()
    state = stages.prop_fn(_tiny_state(), w, a, torch.full((t,), 0.002), t)
    flow8, cov88 = stages.net_fn(stages.prior_fn(state), img1[0], img2[0], keys[0])
    stages.refine_prior_fn(state, flow8, cov88)
    state, _ = stages.upd_fn(state, 0, flow8, cov88)
    return state, flow8, cov88


def test_estimator_stages_emit_their_spans(model, inputs):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run_stages(model, inputs)
    names = Counter(name for name, _, _ in _spans(prof, "vio."))
    assert names["vio.propagate"] == 1 and names["vio.network"] == 1
    assert names["vio.update"] == 2  # the mean-only refinement and the update
    assert names["vio.uahn.call"] == 1


def test_no_record_function_without_a_profiler(model, inputs, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(spans, "record_function", refuse)
    assert spans.span("vio.a") is spans.span("vio.b")  # one shared no-op
    _call(model, inputs, True)
    _call(model, inputs, False, True)
    _run_stages(model, inputs)
    # the patch is where the port opens its spans: under a profiler it fires
    with profile(activities=[ProfilerActivity.CPU]), pytest.raises(AssertionError):
        _call(model, inputs, True)


@pytest.mark.parametrize("use_prior", [True, False], ids=["prior", "full-cascade"])
def test_outputs_do_not_depend_on_the_profiler(model, inputs, use_prior):
    off = _call(model, inputs, use_prior, True)
    with profile(activities=[ProfilerActivity.CPU]):
        on = _call(model, inputs, use_prior, True)
    for x, y in zip(off, on):
        assert torch.equal(x, y)


def test_span_names_are_read_as_spans():
    """Every span the port opens (literal names in ``span(...)`` calls and
    the cascade's ``BLOCK_SPANS``) starts with a prefix the benchmark's
    trace reads as a span, and only ``utils/spans`` enters
    ``record_function``."""
    from cuahn_vio_torch.models.uahn import BLOCK_SPANS

    names = set(BLOCK_SPANS)
    for root, _, files in os.walk(PACKAGE):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                src = fh.read()
            names |= set(re.findall(r"\bspan\(\s*f?[\"']([^\"']+)[\"']", src))
            if os.path.relpath(path, PACKAGE) != os.path.join("utils", "spans.py"):
                assert "record_function" not in src, path
    assert {"vio.propagate", "vio.network", "vio.update", "track.klt", "track.detect"} <= names
    assert set(PRIOR) | set(FULL) <= names
    for name in names:
        assert name.startswith(SPAN_PREFIXES), name
