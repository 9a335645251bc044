"""The UAHN's no-grad call replayed as CUDA graphs (``models/uahn_graphs``).

On the CPU: when a call is captured (a key's second call on the card; never
on the CPU, with the error map, through ``flow_and_cov`` or inside another
capture), the key, the bounded cache, and ``forward`` against its parts
bit for bit. The cache's policy runs here with a stand-in for the capture
that replays the stages eagerly.

On the card (marked ``cuda``, skipped without one): a replay against the
eager call of the same tree bit for bit (V1 on the path of both: 3 launches
a call), at the batches ``close-loops``,
``run-vio``, ``run-vio-batch`` and ``eval-flow`` use; outputs that do not
alias; a recapture after a parameter's storage is swapped; the launch
counters; the spans under the profiler. On the GPU machine:
``python3 -m pytest --noconftest tests/test_torch_uahn_graphs.py``.
"""

import copy
import os

import numpy as np
import pytest
import torch

from cuahn_vio_torch.models import uahn_graphs
from cuahn_vio_torch.models.uahn import UAHN, build_uahn, mask_keys_tensor
from cuahn_vio_torch.ops import cuda as tcuda
from cuahn_vio_torch.ops.cuda.heads import LOGVAR_CLAMP
from cuahn_vio_torch.ops import warp
from cuahn_vio_torch.ops.homography import block_diag_cov8, transfer_mean_var
from cuahn_vio_torch.utils import prng

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "weights", "uahn_fil_v10.msgpack")
STAGES = ("vio.uahn.prior", "vio.uahn.block2", "vio.uahn.block3", "vio.uahn.masks",
          "vio.uahn.block4", "vio.uahn.heads", "vio.uahn.transfer")


def pair_inputs(b, h, w, seed, device="cpu", dtype=torch.uint8):
    """(img1, img2, prior (B, 4, 2) px, numpy call keys (B, 2)) of B
    textured pairs a few pixels apart."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (b, h + 8, w + 8)).astype(np.uint8)
    img1 = torch.as_tensor(base[:, 4:h + 4, 4:w + 4].copy(), device=device)
    img2 = torch.as_tensor(base[:, 2:h + 2, 3:w + 3].copy(), device=device)
    if dtype == torch.float32:
        img1, img2 = img1.float() / 255.0, img2.float() / 255.0
    prior = torch.as_tensor(rng.normal(0.0, 2.0, (b, 4, 2)).astype(np.float32), device=device)
    keys = prng.fold_in(prng.prng_key(seed), np.arange(b))
    return img1, img2, prior, keys


class EagerGraphs:
    """A stand-in for ``StageGraphs`` on the CPU: static copies of the
    inputs, the stages run eagerly on them at each replay."""

    def __init__(self, stages, inputs):
        self.stages = stages
        self.inputs = {k: v.clone() for k, v in inputs.items()}

    def replay(self, inputs):
        for k, v in inputs.items():
            self.inputs[k].copy_(v)
        t = dict(self.inputs)
        for _, step in self.stages:
            t.update(step(t))
        return t["flow8"].clone(), t["cov88"].clone()


@pytest.fixture
def small():
    """A 64x64 UAHN (PyTorch's default init) on the CPU, whose calls the
    cache captures with ``EagerGraphs``."""
    torch.manual_seed(0)
    model = UAHN(dropout_rate=0.05, img_height=64, img_width=64).eval()
    model._graphs = uahn_graphs.GraphCache(EagerGraphs, device_type="cpu")
    tcuda.reset_launch_counts()
    return model


def test_no_capture_on_the_cpu():
    torch.manual_seed(0)
    model = UAHN(dropout_rate=0.05, img_height=64, img_width=64).eval()
    img1, img2, prior, keys = pair_inputs(2, 64, 64, 1)
    tcuda.reset_launch_counts()
    outs = [model(img1, img2, prior, use_prior=True, dropout_keys=keys) for _ in range(3)]
    assert tcuda.uahn_calls == {"eager": 3, "captured": 0, "replayed": 0}
    assert model._graphs.captured() == []
    for flow8, cov88 in outs[1:]:
        assert torch.equal(flow8, outs[0][0]) and torch.equal(cov88, outs[0][1])


def test_first_call_eager_then_capture_then_replay(small):
    img1, img2, prior, keys = pair_inputs(3, 64, 64, 2)
    other = pair_inputs(3, 64, 64, 3)
    eager = small(img1, img2, prior, use_prior=True, dropout_keys=keys)
    assert tcuda.uahn_calls == {"eager": 1, "captured": 0, "replayed": 0}
    replayed = small(img1, img2, prior, use_prior=True, dropout_keys=keys)
    assert tcuda.uahn_calls == {"eager": 1, "captured": 1, "replayed": 1}
    again = small(*other[:3], use_prior=True, dropout_keys=other[3])
    assert tcuda.uahn_calls == {"eager": 1, "captured": 1, "replayed": 2}
    assert len(small._graphs.captured()) == 1
    for a, b in zip(eager, replayed):
        assert torch.equal(a, b)
    with torch.no_grad():
        want = small.flow_and_cov(*other[:3], use_prior=True, dropout_keys=other[3])
    for a, b in zip(want, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("what", ["error_map", "flow_and_cov", "new_shape", "other_mode"])
def test_calls_that_run_eagerly(small, what):
    img1, img2, prior, keys = pair_inputs(2, 64, 64, 4)
    for _ in range(2):  # the key's second call is captured
        small(img1, img2, prior, use_prior=True, dropout_keys=keys)
    before = dict(tcuda.uahn_calls)
    if what == "error_map":
        for _ in range(3):
            out = small(img1, img2, prior, use_prior=True, dropout_keys=keys,
                        return_error_map=True)
            assert len(out) == 3
    elif what == "flow_and_cov":
        for _ in range(3):
            small.flow_and_cov(img1, img2, prior, use_prior=True, dropout_keys=keys)
    elif what == "new_shape":
        one = pair_inputs(1, 64, 64, 5)
        small(*one[:3], use_prior=True, dropout_keys=one[3])
    else:
        small(img1, img2, None, use_prior=False, dropout_keys=keys)
    eager = {"error_map": 3, "flow_and_cov": 0, "new_shape": 1, "other_mode": 1}[what]
    assert tcuda.uahn_calls == dict(before, eager=before["eager"] + eager)
    assert len(small._graphs.captured()) == 1


def test_a_new_parameter_storage_recaptures(small):
    img1, img2, prior, keys = pair_inputs(2, 64, 64, 6)
    call = lambda: small(img1, img2, prior, use_prior=True, dropout_keys=keys)  # noqa: E731
    call(), call()
    (first,) = small._graphs.captured()
    # an in-place update keeps the key (the replay reads the new values)
    with torch.no_grad():
        small.fc_block2.bias.add_(0.5)
    updated = call()
    assert small._graphs.captured() == [first]
    with torch.no_grad():
        want = small.flow_and_cov(img1, img2, prior, use_prior=True, dropout_keys=keys)
    assert torch.equal(updated[0], want[0]) and torch.equal(updated[1], want[1])
    # new storage: a new key, eager once, then captured
    small.block4.conv0.weight.data = small.block4.conv0.weight.data.clone()
    before = dict(tcuda.uahn_calls)
    call()
    assert tcuda.uahn_calls["eager"] == before["eager"] + 1
    call()
    assert tcuda.uahn_calls["captured"] == before["captured"] + 1
    assert len(small._graphs.captured()) == 2 and small._graphs.captured()[0] == first


def test_the_key_follows_the_kernel_settings(small):
    img1, img2, prior, keys = pair_inputs(2, 64, 64, 7)
    t = small._call_inputs(img1, img2, prior, True, keys)
    key = small._graphs.key(small, t, True)
    assert key == small._graphs.key(small, small._call_inputs(img1, img2, prior, True, keys), True)
    was = warp.BATCH_SAMPLER
    try:
        warp.BATCH_SAMPLER = "rowskip"
        assert small._graphs.key(small, t, True) != key
    finally:
        warp.BATCH_SAMPLER = was
    was = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = not was
        assert small._graphs.key(small, t, True) != key
    finally:
        torch.backends.cudnn.allow_tf32 = was
    small.dropout_rate = 0.1
    assert small._graphs.key(small, t, True) != key
    assert small._graphs.key(small, dict(t, prior=None), True) is None


def test_the_cache_holds_a_handful_of_keys():
    built = []
    cache = uahn_graphs.GraphCache(lambda stages, inputs: built.append(inputs) or len(built),
                                   device_type="cpu")
    n = uahn_graphs.MAX_KEYS + 2
    for k in range(n):
        assert cache.lookup(("k", k), list, {"i": k}) is None  # first call: eager
        assert cache.lookup(("k", k), list, {"i": k}) == k + 1  # second: captured
    assert len(built) == n
    assert cache.captured() == [("k", k) for k in range(2, n)]
    # a replay makes its key the most recently used
    assert cache.lookup(("k", 2), list, {}) == 3
    assert cache.lookup(("k", n), list, {}) is None
    assert cache.lookup(("k", n), list, {}) == n + 1
    assert cache.captured() == [("k", k) for k in (4, 5, 2, n)]
    # an evicted key starts again from its first call
    assert cache.lookup(("k", 0), list, {}) is None
    assert len(built) == n + 1


def test_keys_seen_once_are_bounded():
    cache = uahn_graphs.GraphCache(lambda stages, inputs: "graphs", device_type="cpu")
    for k in range(uahn_graphs.MAX_SEEN + 1):
        assert cache.lookup(k, list, {}) is None
    assert cache.lookup(0, list, {}) is None  # forgotten: eager again
    assert cache.lookup(uahn_graphs.MAX_SEEN, list, {}) == "graphs"


def test_a_copy_of_the_model_starts_with_no_graphs(small):
    img1, img2, prior, keys = pair_inputs(2, 64, 64, 8)
    for _ in range(2):
        small(img1, img2, prior, use_prior=True, dropout_keys=keys)
    twin = copy.deepcopy(small)
    assert twin._graphs is not small._graphs and twin._graphs.captured() == []
    assert twin._graphs.device_type == "cpu" and len(small._graphs.captured()) == 1


def test_keys_are_checked_before_the_call(small):
    img1, img2, prior, keys = pair_inputs(2, 64, 64, 9)
    with pytest.raises(ValueError, match="needs dropout_keys"):
        small(img1, img2, prior, use_prior=True)
    with pytest.raises(ValueError, match="must be"):
        small(img1, img2, prior, use_prior=True, dropout_keys=keys[:1])
    with pytest.raises(ValueError, match="needs prior_offset"):
        small(img1, img2, None, use_prior=True, dropout_keys=keys)
    assert tcuda.uahn_calls["captured"] == 0


@pytest.mark.parametrize("use_prior", [True, False])
@pytest.mark.parametrize("tensor_keys", [True, False])
def test_forward_is_its_parts(use_prior, tensor_keys):
    """``forward`` on the CPU computes what the public pieces compose, bit
    for bit: part 1's homography (``cascade_flows``), block 4's members,
    the ensemble statistics, the covariance transfer (the JAX-parity tests
    hold those pieces)."""
    torch.manual_seed(1)
    model = UAHN(dropout_rate=0.05, img_height=64, img_width=64).eval()
    img1, img2, prior, keys = pair_inputs(3, 64, 64, 10)
    if tensor_keys:
        keys = mask_keys_tensor(keys, "cpu")
    flow8, cov88 = model(img1, img2, prior, use_prior=use_prior, dropout_keys=keys)
    with torch.no_grad():
        h = model.cascade_flows(img1, img2, prior, use_prior)[1]
        means, logvars = model.last_block_members(img1, img2, h, keys)
        logvars = torch.clamp(logvars, -LOGVAR_CLAMP, LOGVAR_CLAMP)
        mean_avg = means.mean(dim=1)
        var = torch.square(means - mean_avg[:, None]).mean(dim=1) + torch.exp(logvars).mean(dim=1)
        pts, cov_4pt = transfer_mean_var(var, h, model.corners + mean_avg)
    assert torch.equal(flow8, (pts - model.corners).reshape(-1, 8))
    assert torch.equal(cov88, block_diag_cov8(cov_4pt))


# ------------------------------------------------------------------ the card


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the CUDA kernels have no CPU mode")
    from cuahn_vio_torch.ops.homography import f32_parity_mode
    from cuahn_vio_torch.utils.checkpoint import load_params

    f32_parity_mode()
    return build_uahn(load_params(WEIGHTS), device="cuda:0")


def _eager(model, img1, img2, prior, use_prior, keys):
    with torch.no_grad():
        return model.flow_and_cov(img1, img2, prior, use_prior, keys)


@pytest.mark.cuda
@pytest.mark.parametrize("b,use_prior,dtype", [
    (64, True, torch.uint8),  # close-loops
    (1, True, torch.uint8),  # run-vio
    (8, True, torch.uint8),  # run-vio-batch
    (12, True, torch.uint8),
    (64, True, torch.float32),
    (16, False, torch.float32),  # eval-flow --prior none
])
def test_replay_is_the_eager_call(gpu, b, use_prior, dtype):
    model = gpu
    model._graphs = uahn_graphs.GraphCache()
    calls = [pair_inputs(b, 224, 320, 100 + s, "cuda:0", dtype) for s in range(4)]
    outs = []
    for img1, img2, prior, keys in calls:
        outs.append(model(img1, img2, prior if use_prior else None, use_prior=use_prior,
                          dropout_keys=keys))
    assert len(model._graphs.captured()) == 1
    before = tcuda.launch_counts["lowc_conv"]
    for (img1, img2, prior, keys), out in zip(calls, outs):
        want = _eager(model, img1, img2, prior if use_prior else None, use_prior, keys)
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
    # the eager calls ran block 3's conv0 and block 4's conv0 and conv1 on V1
    assert tcuda.launch_counts["lowc_conv"] == before + 3 * len(calls)
    # successive replays return tensors of their own
    ptrs = {t.data_ptr() for out in outs for t in out}
    assert len(ptrs) == 2 * len(outs)


@pytest.mark.cuda
def test_replays_recapture_after_a_new_storage(gpu):
    model = gpu
    model._graphs = uahn_graphs.GraphCache()
    img1, img2, prior, keys = pair_inputs(64, 224, 320, 200, "cuda:0")
    call = lambda: model(img1, img2, prior, use_prior=True, dropout_keys=keys)  # noqa: E731
    call(), call()
    weight = model.block4.conv6.weight
    saved = weight.data.clone()
    try:
        with torch.no_grad():
            weight.mul_(1.5)  # in place: the same key, the new values replayed
        out = call()
        assert len(model._graphs.captured()) == 1
        want = _eager(model, img1, img2, prior, True, keys)
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
        weight.data = saved.clone()  # new storage: a new key
        tcuda.reset_launch_counts()
        first, second = call(), call()
        assert tcuda.uahn_calls == {"eager": 1, "captured": 1, "replayed": 1}
        want = _eager(model, img1, img2, prior, True, keys)
        for out in (first, second):
            assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
    finally:
        weight.data = saved


@pytest.mark.cuda
def test_launch_counters_move_alike(gpu):
    model = gpu
    model._graphs = uahn_graphs.GraphCache()
    img1, img2, prior, keys = pair_inputs(64, 224, 320, 300, "cuda:0")
    moved = []
    for _ in range(3):  # eager, captured and replayed, replayed
        before = [dict(c) for c in tcuda.LAUNCH_COUNTERS]
        model(img1, img2, prior, use_prior=True, dropout_keys=keys)
        moved.append([{k: c[k] - b[k] for k in c} for c, b in zip(tcuda.LAUNCH_COUNTERS, before)])
    assert moved[0] == moved[1] == moved[2]
    assert moved[0][0]["homography_warp"] == 3 and moved[0][0]["threefry"] == 1
    assert moved[0][0]["lowc_conv"] == 3  # V1: block 3's conv0, block 4's conv0 and conv1
    assert moved[0][1]["bernoulli"] == 1


@pytest.mark.cuda
def test_spans_of_a_replayed_call(gpu):
    from torch.profiler import ProfilerActivity, profile

    model = gpu
    model._graphs = uahn_graphs.GraphCache()
    img1, img2, prior, keys = pair_inputs(64, 224, 320, 400, "cuda:0")
    for _ in range(2):
        model(img1, img2, prior, use_prior=True, dropout_keys=keys)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(img1, img2, prior, use_prior=True, dropout_keys=keys)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.name.startswith("vio.")
             and e.device_type == torch.autograd.DeviceType.CPU]
    for name in ("vio.uahn.call", "vio.uahn.replay") + STAGES:
        assert names.count(name) == 1, (name, names)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("vio.")]
    assert len(kernels) > 100
