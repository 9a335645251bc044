"""The port at the shipped MC-dropout rate (p = 0.05) against the JAX
package on the CPU: with the JAX random stream (``utils/prng``) the port
draws the JAX package's masks at a seed, so the parity tests hold at the
production setting, not only at p = 0.

- the UAHN with one key, in prior mode (blocks 2-4) and at
  ``use_prior=False``, and a batch of two rows with their own keys:
  flow and ``cov88`` within ``tests/test_torch_uahn.py``'s tolerances
  (flow 5e-4 px; cov 1e-4 relative plus 1e-4 px²);
- ``run_offline`` and ``run_stepwise`` (staged and fused) at seed 5 on
  ``tests/test_torch_slice.py``'s sequence and options (IEKF 2, update
  gate 2, the bias block on): the JAX ``run_offline``'s poses within its
  tolerances (positions 2e-5 m, quaternions 1e-6, covariances 1e-6,
  flows 1e-3 px). The JAX ``run_stepwise`` takes each frame pair's key
  one later than its ``run_offline`` (VERDICT.md:140-147): the port's
  ``run_stepwise`` equals the JAX ``run_offline``;
- ``run_offline_batch`` against the JAX ``batched_run_sequences`` with the
  keys of the JAX ``run-vio-batch``, ``split(PRNGKey(seed), B)``, at the
  same tolerances;
- ``eval-flow --prior noisy`` (``tests/test_torch_diagnostics.py``'s
  sequence) and ``close-loops`` (``tests/test_torch_loop_closure.py``'s
  revisits) against the JAX verbs, at those files' tolerances.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuahn_vio import cli as jcli
from cuahn_vio.data.synthetic import AnalyticTrajectory as JaxTraj
from cuahn_vio.data.synthetic import make_sequence as jax_make_sequence
from cuahn_vio.models.uahn import UAHN as JaxUAHN
from cuahn_vio.parallel.sharded_eval import batched_run_sequences as jax_batched_run
from cuahn_vio.pipeline.runner import _outputs_to_result as jax_outputs_to_result
from cuahn_vio.pipeline.runner import prepare_sequence as jax_prepare_sequence
from cuahn_vio.pipeline.runner import run_offline as jax_run_offline
from cuahn_vio.pipeline.vio import VioConfig as JaxVioConfig
from cuahn_vio.utils.config import VioOptions as JaxVioOptions
from cuahn_vio_torch import cli as tcli
from cuahn_vio_torch.eval.flow import eval_flow
from cuahn_vio_torch.models.uahn import build_uahn
from cuahn_vio_torch.ops import cuda as tcuda
from cuahn_vio_torch.pipeline.runner import run_offline, run_offline_batch, run_stepwise
from cuahn_vio_torch.pipeline.vio import VioConfig
from cuahn_vio_torch.utils import prng
from cuahn_vio_torch.utils.checkpoint import load_params
from cuahn_vio_torch.utils.config import VioOptions
from test_torch_diagnostics import sequence as diag_sequence  # noqa: F401
from test_torch_loop_closure import revisits, run_files  # noqa: F401

# the suite runs in several worker processes: keep torch to a few threads
torch.set_num_threads(2)

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "weights", "uahn_fil_v10.msgpack")
RATE = 0.05
SEED = 5
NET_FLOW_ATOL = 5e-4
NET_COV_ATOL = 1e-4
NET_COV_RTOL = 1e-4
POS_ATOL = 2e-5
Q_ATOL = 1e-6
COV_ATOL = 1e-6
FLOW_ATOL = 1e-3
TRUE_TOL_PX = 1e-4
DP_TOL_M = 1e-3
DQ_TOL = 1e-5
SIGMA_RTOL = 1e-3
SEQ_KW = dict(duration=0.6, seed=1, sigma_w=0.002, sigma_a=0.02, bias_g=0.003,
              bias_a=0.02, texture_seed=1)
CFG = dict(max_iekf_iterations=2, update_gate_frames=2)


def _seq_options(cls):
    """``tests/test_torch_slice.py``'s options: the config make-synthetic
    writes, with the OU bias block on."""
    opts = cls().apply_profile("calibrated")
    opts.calib_camimu_dt = 0.0
    opts.init_height = 1.5
    opts.init_imu_thresh = 0.2
    opts.meas_bias_sigma_px = 2.0
    return opts


@pytest.fixture(scope="module")
def jax_params():
    from flax import serialization

    with open(WEIGHTS, "rb") as f:
        return serialization.msgpack_restore(f.read())


@pytest.fixture(scope="module")
def model():
    return build_uahn(load_params(WEIGHTS), device="cpu", dropout_rate=RATE)


@pytest.fixture(scope="module")
def frames():
    """``tests/test_torch_uahn.py``'s textured pair and prior offset."""
    rng = np.random.default_rng(30)
    base = rng.integers(0, 256, (232, 330)).astype(np.uint8)
    return base[4:228, 5:325].copy(), base[2:226, 2:322].copy(), \
        rng.normal(0, 2.0, (4, 2)).astype(np.float32)


def _jax_uahn(params, img1, img2, prior, use_prior, key):
    f, c = JaxUAHN(dropout_rate=RATE).apply(
        {"params": params}, jnp.array(img1, jnp.float32) / 255.0,
        jnp.array(img2, jnp.float32) / 255.0, jnp.array(prior) if use_prior else None,
        use_prior=use_prior, rngs={"dropout": jnp.asarray(key)})
    return np.asarray(f), np.asarray(c)


@pytest.mark.parametrize("use_prior", [True, False], ids=["prior", "no_prior"])
def test_uahn_with_dropout_matches_flax(jax_params, model, frames, use_prior):
    img1, img2, prior = frames
    key = prng.prng_key(11)
    ref_f, ref_c = _jax_uahn(jax_params, img1, img2, prior, use_prior, key)
    f, c = model(torch.from_numpy(img1)[None], torch.from_numpy(img2)[None],
                 torch.from_numpy(prior)[None], use_prior=use_prior, dropout_keys=key[None])
    np.testing.assert_allclose(f[0].numpy(), ref_f, atol=NET_FLOW_ATOL, rtol=0)
    np.testing.assert_allclose(c[0].numpy(), ref_c, atol=NET_COV_ATOL, rtol=NET_COV_RTOL)
    # the masks matter: the same call at p = 0 is far off
    f0, _ = build_uahn(load_params(WEIGHTS), device="cpu", dropout_rate=0.0)(
        torch.from_numpy(img1)[None], torch.from_numpy(img2)[None],
        torch.from_numpy(prior)[None], use_prior=use_prior)
    assert np.abs(f0[0].numpy() - ref_f).max() > 20 * NET_FLOW_ATOL


def test_uahn_batch_rows_keep_their_own_keys(jax_params, model, frames):
    """Two rows with two keys (the pair and its reverse) in one call, each
    against the JAX model with its key."""
    img1, img2, prior = frames
    keys = prng.split(prng.prng_key(3), 2)
    f, c = model(torch.from_numpy(np.stack([img1, img2])),
                 torch.from_numpy(np.stack([img2, img1])),
                 torch.from_numpy(np.stack([prior, -prior])), use_prior=True,
                 dropout_keys=prng.keys_tensor(prng.mask_keys(keys)))
    for i, (a, b, pr) in enumerate(((img1, img2, prior), (img2, img1, -prior))):
        ref_f, ref_c = _jax_uahn(jax_params, a, b, pr, True, keys[i])
        np.testing.assert_allclose(f[i].numpy(), ref_f, atol=NET_FLOW_ATOL, rtol=0)
        np.testing.assert_allclose(c[i].numpy(), ref_c, atol=NET_COV_ATOL, rtol=NET_COV_RTOL)


@pytest.fixture(scope="module")
def sequence():
    opts = _seq_options(JaxVioOptions)
    seq = jax_make_sequence(JaxTraj(), np.asarray(opts.t_imu_to_cam), **SEQ_KW)
    return seq.imu_t, seq.imu_w, seq.imu_a, seq.cam_t, seq.frames


@pytest.fixture(scope="module")
def jax_run(sequence, jax_params):
    jo = _seq_options(JaxVioOptions)
    return jax_run_offline(*sequence, JaxUAHN(dropout_rate=RATE), jax_params,
                           jo.filter_params(), JaxVioConfig(**CFG), jo.runner_options(),
                           seed=SEED)


def _assert_runs_match(out, ref):
    assert len(out.times) == len(ref.times) >= 2
    np.testing.assert_array_equal(out.times, ref.times)
    np.testing.assert_allclose(out.pose_w[:, :3], ref.pose_w[:, :3], atol=POS_ATOL, rtol=0)
    np.testing.assert_allclose(out.pose_w[:, 3:], ref.pose_w[:, 3:], atol=Q_ATOL, rtol=0)
    np.testing.assert_allclose(out.cov_core, ref.cov_core, atol=COV_ATOL, rtol=0)
    np.testing.assert_allclose(out.net_mean, ref.net_mean, atol=FLOW_ATOL, rtol=0)


@pytest.mark.parametrize("runner", ["offline", "staged", "fused"])
def test_runners_with_dropout_match_jax_run_offline(sequence, model, jax_run, runner):
    to = _seq_options(VioOptions)
    args = (*sequence, model, to.filter_params("cpu"), VioConfig(**CFG), to.runner_options())
    before = dict(tcuda.launch_counts)
    if runner == "offline":
        out = run_offline(*args, seed=SEED, device="cpu")
    else:
        out = run_stepwise(*args, seed=SEED, device="cpu", staged_timing=runner == "staged")
    assert tcuda.launch_counts == before  # the CPU path launches no kernel
    assert len(out.times) >= 8 and (out.net_chi2[3:] > 0).all()  # the updates ran
    _assert_runs_match(out, jax_run)
    if runner == "offline":  # another seed draws other masks
        other = run_offline(*args, seed=SEED + 1, device="cpu")
        assert np.abs(other.net_mean - jax_run.net_mean).max() > 10 * FLOW_ATOL


def test_run_offline_batch_with_dropout_matches_jax_batch(sequence, model, jax_params):
    """Two sequences (the slice's, and the same less its last 4 frames: the
    batch pads) through ``run_offline_batch`` and the JAX ``batched_run_sequences``
    with ``split(PRNGKey(seed), 2)``, the JAX ``run-vio-batch``'s keys."""
    imu_t, imu_w, imu_a, cam_t, frames_u8 = sequence
    seqs = [sequence, (imu_t, imu_w, imu_a, cam_t[:-4], frames_u8[:-4])]
    to = _seq_options(VioOptions)
    got = run_offline_batch(seqs, model, to.filter_params("cpu"), VioConfig(**CFG),
                            to.runner_options(), seed=SEED, device="cpu")
    jo = _seq_options(JaxVioOptions)
    fparams = jo.filter_params()
    preps = [jax_prepare_sequence(*seq, jo.runner_options(), fparams) for seq in seqs]
    n_frames = [p[2].dt.shape[0] for p in preps]
    assert n_frames[1] < n_frames[0]
    f_max = max(n_frames)
    imgs, ws, a_s, dts = [], [], [], []
    for (_, _, win, _, fr), nf in zip(preps, n_frames):
        pad = f_max - nf
        imgs.append(np.concatenate([fr, np.repeat(fr[-1:], pad, 0)]))
        ws.append(np.pad(win.w_mid, ((0, pad), (0, 0), (0, 0))))
        a_s.append(np.pad(win.a_mid, ((0, pad), (0, 0), (0, 0))))
        dts.append(np.pad(win.dt, ((0, pad), (0, 0))))
    states0 = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[1] for p in preps])
    _, outs = jax_batched_run(
        states0, JaxUAHN(dropout_rate=RATE), jax_params, fparams, JaxVioConfig(**CFG),
        jnp.asarray(np.stack(imgs)), jnp.asarray(np.stack(ws)), jnp.asarray(np.stack(a_s)),
        jnp.asarray(np.stack(dts)), jax.random.split(jax.random.PRNGKey(SEED), len(preps)))
    for i, ((init, _, _, cam_used, _), nf) in enumerate(zip(preps, n_frames)):
        out_i = jax.tree.map(lambda x: np.asarray(x[i][:nf]), outs)
        ref = jax_outputs_to_result(out_i, cam_used[1:nf + 1] + jo.calib_camimu_dt, init.t0)
        _assert_runs_match(got[i], ref)


def test_eval_flow_noisy_prior_with_dropout_matches_the_jax_verb(diag_sequence, model,
                                                                  monkeypatch):
    """``eval-flow --prior noisy --seed 3`` at p = 0.05: the prior's noise
    ``2 normal(fold_in(rng, 10_000 + s))`` and pair i's masks of
    ``fold_in(rng, i)`` are the JAX verb's (batches of 3 over 4 pairs)."""
    from cuahn_vio_torch.eval.simulation import load_state_gt

    monkeypatch.chdir(diag_sequence)
    jcli.main(["eval-flow", "seq.npz", "seq_state_gt.txt", "--weights", WEIGHTS, "--prior",
               "noisy", "--limit", "4", "--batch", "3", "--seed", "3", "--out", "jax.npz"])
    want = np.load("jax.npz")
    d = np.load("seq.npz")
    fp = VioOptions.uzhfpv_indoor45().filter_params("cpu")
    gt = load_state_gt("seq_state_gt.txt")
    ev = eval_flow(d["frames"], d["cam_t"], gt.times, gt.pose, fp.c_rot_i, fp.i_t_i2c,
                   model, prior="noisy", batch=3, limit=4, seed=3)
    np.testing.assert_allclose(ev.true, want["true"], atol=TRUE_TOL_PX, rtol=0)
    np.testing.assert_allclose(ev.pred, want["pred"], atol=NET_FLOW_ATOL, rtol=0)
    np.testing.assert_allclose(ev.cov, want["cov"], atol=NET_COV_ATOL, rtol=NET_COV_RTOL)


def test_close_loops_with_dropout_matches_the_jax_verb(run_files, capsys):
    """``close-loops`` at p = 0.05: candidate pair n's masks are those of
    ``fold_in(PRNGKey(0), n)`` in both verbs (neither takes a seed) (the port's batches of up
    to 64 pairs give each pair its own key)."""
    from test_torch_loop_closure import _read_factors

    d = run_files
    flags = ["--weights", WEIGHTS, "--min-dt", "3.0", "--max-dist", "3.0", "--stride", "1",
             "--max-sigma-px", "25"]
    jcli.main(["close-loops", str(d / "seq.npz"), str(d / "state.npz"), "--out",
               str(d / "jl5.txt"), *flags])
    tcli.main(["close-loops", str(d / "seq.npz"), str(d / "state.npz"), "--out",
               str(d / "tl5.txt"), "--device", "cpu", *flags])
    capsys.readouterr()
    want, got = _read_factors(d / "jl5.txt"), _read_factors(d / "tl5.txt")
    assert len(want.pairs) > 0
    np.testing.assert_array_equal(got.pairs, want.pairs)
    np.testing.assert_allclose(got.dp_meas, want.dp_meas, atol=DP_TOL_M, rtol=0)
    np.testing.assert_allclose(got.dq_meas, want.dq_meas, atol=DQ_TOL, rtol=0)
    np.testing.assert_allclose(got.sigma_p, want.sigma_p, rtol=SIGMA_RTOL, atol=0)
