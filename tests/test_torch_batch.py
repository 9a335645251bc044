"""The port's batched path (``run-vio-batch``) against cuahn_vio on the CPU.

- The row-band batched warp (B3): on the CPU its plain version is
  ``homography_warp_plain`` (B3 computes B2's function bit for bit), held
  to the Pallas ``_sample_lanes_rowskip`` in interpret mode on the cases of
  ``tests/test_pallas_warp.py::test_rowskip_matches_full_including_extreme_roll``
  (a near-identity homography, a 90 deg roll, a fully off-image warp and
  the identity) at 224x320: 1e-5 absolute, as the warp's own tests.
- ``run_offline_batch`` over B = 3 short sequences of different lengths
  (so the batch pads), v10 weights at dropout_rate = 0, IEKF 2, the bias
  block on and the update gate at 2 frames: equal to the port's
  ``run_offline`` on each sequence and to the JAX package's
  ``batched_run_sequences`` on the same inputs, world positions 2e-5 m,
  quaternions 1e-6, covariances 1e-6, network flows 1e-3 px, as
  ``tests/test_torch_slice.py`` holds the single-stream slice (measured
  against run_offline ~1e-7 m).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuahn_vio.models.uahn import UAHN as JaxUAHN
from cuahn_vio.ops.pallas import warp_kernel as wk
from cuahn_vio.parallel.sharded_eval import batched_run_sequences as jax_batched_run
from cuahn_vio.pipeline.runner import _outputs_to_result as jax_outputs_to_result
from cuahn_vio.pipeline.runner import prepare_sequence as jax_prepare_sequence
from cuahn_vio.pipeline.vio import VioConfig as JaxVioConfig
from cuahn_vio.utils.config import VioOptions as JaxVioOptions
from cuahn_vio_torch.data.synthetic import AnalyticTrajectory, make_sequence
from cuahn_vio_torch.models.uahn import build_uahn
from cuahn_vio_torch.ops import cuda as tcuda
from cuahn_vio_torch.ops import warp as twarp
from cuahn_vio_torch.parallel.sharded_eval import batched_run_sequences
from cuahn_vio_torch.pipeline.runner import (
    prepare_batch,
    resolve_device,
    run_offline,
    run_offline_batch,
)
from cuahn_vio_torch.pipeline.vio import VioConfig
from cuahn_vio_torch.utils.checkpoint import load_params
from cuahn_vio_torch.utils.config import VioOptions

# the suite runs in several worker processes: keep torch to a few threads
torch.set_num_threads(2)

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "weights", "uahn_fil_v10.msgpack")
WARP_TOL = 1e-5
POS_ATOL = 2e-5
Q_ATOL = 1e-6
COV_ATOL = 1e-6
FLOW_ATOL = 1e-3
SEQS = ((0.6, 1), (0.45, 2), (0.3, 3))  # (duration s, seed): 11, 7 and 2 frames
CFG = dict(max_iekf_iterations=2, update_gate_frames=2)


def _roll(deg):
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    return [[c, -s, 160.0 + s * 111.5 - c * 159.5],
            [s, c, 111.5 - s * 159.5 - c * 111.5], [0.0, 0.0, 1.0]]


@pytest.mark.parametrize("exact_u8", [True, False])
def test_rowskip_plain_path_matches_pallas_rowskip(exact_u8):
    rng = np.random.default_rng(0)
    hs = np.array([
        [[1.02, 0.01, -2.0], [0.005, 0.98, 1.5], [1e-5, -2e-5, 1.0]],
        _roll(90.0),
        [[1.0, 0.0, 5000.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],  # fully off-image
        np.eye(3),
    ], np.float32)
    if exact_u8:
        imgs_t = rng.integers(0, 256, (4, 224, 320)).astype(np.uint8)
        imgs_j = imgs_t.astype(np.float32) / 255.0
    else:
        imgs_t = imgs_j = rng.random((4, 224, 320)).astype(np.float32)
    # the coordinates homography_warp_pallas_batch hands its sampler
    uvz = jnp.einsum("bij,jp->bip", jnp.asarray(hs), wk.pixel_grid_uv1(224, 320),
                     precision=jax.lax.Precision.HIGHEST)
    su, sv = uvz[:, 0] / uvz[:, 2], uvz[:, 1] / uvz[:, 2]
    ref = np.asarray(wk._sample_lanes_rowskip(jnp.asarray(imgs_j), su, sv, True, exact_u8))
    ref = ref.reshape(4, 224, 320)
    twarp.BATCH_SAMPLER = "rowskip"
    try:
        out = twarp.homography_warp(torch.as_tensor(imgs_t), torch.as_tensor(hs)).numpy()
    finally:
        twarp.BATCH_SAMPLER = "full"
    np.testing.assert_allclose(out, ref, atol=WARP_TOL, rtol=0)
    assert (out[2] == 0.0).all() and np.abs(out[3] - imgs_j[3]).max() < 1e-6


def test_batch_sampler_selector_is_checked():
    imgs = torch.zeros((2, 8, 8), dtype=torch.uint8)
    hs = torch.eye(3).expand(2, 3, 3).contiguous()
    twarp.BATCH_SAMPLER = "fast"
    try:
        with pytest.raises(ValueError, match="BATCH_SAMPLER"):
            twarp.homography_warp(imgs, hs)
    finally:
        twarp.BATCH_SAMPLER = "full"


def _options(cls):
    opts = cls().apply_profile("calibrated")
    opts.calib_camimu_dt = 0.0
    opts.init_height = 1.5
    opts.init_imu_thresh = 0.2
    opts.meas_bias_sigma_px = 2.0
    return opts


@pytest.fixture(scope="module")
def sequences():
    t_ic = np.asarray(VioOptions().t_imu_to_cam)
    out = []
    for duration, seed in SEQS:
        s = make_sequence(AnalyticTrajectory(), t_ic, duration=duration, seed=seed,
                          sigma_w=0.002, sigma_a=0.02, bias_g=0.003, bias_a=0.02,
                          texture_seed=seed, device="cpu")
        out.append((s.imu_t, s.imu_w, s.imu_a, s.cam_t, s.frames))
    return out


@pytest.fixture(scope="module")
def model():
    return build_uahn(load_params(WEIGHTS), device="cpu", dropout_rate=0.0)


@pytest.fixture(scope="module")
def batched(sequences, model):
    opts = _options(VioOptions)
    before = dict(tcuda.launch_counts)
    res = run_offline_batch(sequences, model, opts.filter_params("cpu"), VioConfig(**CFG),
                            opts.runner_options(), device="cpu")
    assert tcuda.launch_counts == before  # the CPU path launches no kernel
    return res


def _assert_runs_match(out, ref):
    assert len(out.times) == len(ref.times)
    np.testing.assert_array_equal(out.times, ref.times)
    np.testing.assert_allclose(out.pose_w[:, :3], ref.pose_w[:, :3], atol=POS_ATOL, rtol=0)
    np.testing.assert_allclose(out.pose_w[:, 3:], ref.pose_w[:, 3:], atol=Q_ATOL, rtol=0)
    np.testing.assert_allclose(out.cov_core, ref.cov_core, atol=COV_ATOL, rtol=0)
    np.testing.assert_allclose(out.net_mean, ref.net_mean, atol=FLOW_ATOL, rtol=0)


def test_batched_run_matches_single_runs(sequences, model, batched):
    opts = _options(VioOptions)
    assert [len(r.times) for r in batched] == [11, 7, 2]
    for seq, res in zip(sequences, batched):
        single = run_offline(*seq, model, opts.filter_params("cpu"), VioConfig(**CFG),
                             opts.runner_options(), device="cpu")
        _assert_runs_match(res, single)
    # the updates ran past the gate
    assert (batched[0].net_chi2[3:] > 0).all()


def test_batched_run_matches_jax_batched_run_sequences(sequences, batched):
    from flax import serialization

    with open(WEIGHTS, "rb") as f:
        params = serialization.msgpack_restore(f.read())
    jo = _options(JaxVioOptions)
    fparams = jo.filter_params()
    preps = [jax_prepare_sequence(*seq, jo.runner_options(), fparams) for seq in sequences]
    n_frames = [p[2].dt.shape[0] for p in preps]
    f_max = max(n_frames)
    imgs, ws, a_s, dts = [], [], [], []
    for (_, _, win, _, frames), nf in zip(preps, n_frames):
        pad = f_max - nf
        imgs.append(np.concatenate([frames, np.repeat(frames[-1:], pad, 0)]))
        ws.append(np.pad(win.w_mid, ((0, pad), (0, 0), (0, 0))))
        a_s.append(np.pad(win.a_mid, ((0, pad), (0, 0), (0, 0))))
        dts.append(np.pad(win.dt, ((0, pad), (0, 0))))
    states0 = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[1] for p in preps])
    _, outs = jax_batched_run(
        states0, JaxUAHN(dropout_rate=0.0), params, fparams, JaxVioConfig(**CFG),
        jnp.asarray(np.stack(imgs)), jnp.asarray(np.stack(ws)), jnp.asarray(np.stack(a_s)),
        jnp.asarray(np.stack(dts)), jax.random.split(jax.random.PRNGKey(0), len(preps)),
    )
    for i, ((init, _, _, cam_used, _), nf) in enumerate(zip(preps, n_frames)):
        out_i = jax.tree.map(lambda x: np.asarray(x[i][:nf]), outs)
        ref = jax_outputs_to_result(out_i, cam_used[1:nf + 1] + jo.calib_camimu_dt, init.t0)
        _assert_runs_match(batched[i], ref)


def test_prepare_batch_pads_with_repeats_and_zero_dt(sequences):
    opts = _options(VioOptions)
    batch = prepare_batch(sequences, opts.runner_options(), opts.filter_params("cpu"), "cpu")
    assert batch.n_frames == [11, 7, 2]
    assert batch.imgs_u8.shape[:2] == (3, 12) and batch.dt_win.shape[:2] == (3, 11)
    assert batch.states0.p.shape == (3, 3) and batch.states0.cov_bb.shape == (3, 8, 8)
    # sequence 2: two real frames, then repeats of its last frame and
    # zero-dt windows
    assert (batch.imgs_u8[2, 3:] == batch.imgs_u8[2, 2]).all()
    assert (batch.dt_win[2, 2:] == 0).all() and (batch.n_used[2, 2:] == 0).all()
    assert (batch.n_used[:, :2] > 0).all()


def test_batched_run_sequences_refuses_a_mesh(sequences):
    """A mesh whose devices do not split the batch evenly is refused (the
    sharding itself is tested in ``tests/test_torch_parallel.py``)."""
    from cuahn_vio_torch.parallel.mesh import Mesh

    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="does not split"):
        batched_run_sequences(None, None, None, None, torch.zeros((3, 2, 4, 4), dtype=torch.uint8),
                              None, None, None, np.zeros((3, 1)), None,
                              mesh=Mesh(devices=(cpu, cpu)))


def test_resolve_device_names_the_current_cuda_device(monkeypatch):
    """A bare "cuda" is the current CUDA device, where tensors made with
    device="cuda" live: the runners' device check compares against it."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")
