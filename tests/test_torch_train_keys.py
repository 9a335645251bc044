"""The trainer's draws from the JAX key chain (``train/trainer``:
``draw_pairs``, ``make_batch``, the held-out probe) against the JAX
trainer's at the same keys, on the CPU at the JAX tests' 56x80, on a bank
of four procedural 128x128 textures that both packages read.

The JAX draws are recomputed from ``sample_pair``'s key splits
(``split(key, B)``, each sample's ``split(k, 16)``, the texture's,
effects' and ground's own splits) with ``jax.random``; the JAX batches are
the JAX trainer's jitted ``make_batch(kb, ...)``.

Tolerances:
- every uniform, Bernoulli and randint draw (heights, yaws, texture
  picks, exposures, the effects' uniforms, the coins, the bank picks, the
  procedural ground's frequencies and phases): equal; every normal (tilt,
  dp, rv_d, the prior's noise, the effects' offset and drift) within
  2.4e-7 times its scale (XLA's CPU ``log1p``); what the trainer derives
  from them in float32 (quaternions, texture transforms, the prior's
  sigma, the bank pairs turned by their yaw): within 1e-6 (relative for
  the transforms and sigmas);
- the batch: ``gt_flow`` and the prior within 1e-4 px, ``valid`` equal;
  each frame, but for the ground beyond NEAR_M of the camera and FAR_REACH
  pixels around it (at grazing angles a float32 rounding moves a far
  ground point by much of a texel, and the defocus blur and the blur taps
  carry that a few pixels), at most one uint8 level from the JAX frame and
  equal on at least 99.9 % of those pixels (``tests/test_torch_train.py``'s
  rendered-pair bound);
- the probe's batch (4 pairs on the held-out texture) the same way, and
  ``make_probe_metric``'s prior-mode error equal to that of the batch
  ``make_batch`` gives at ``PRNGKey(probe_seed)``;
- ``chip_smoke.py``'s committed JAX draws of phases 11 and 14 against the
  port's on the CPU, under the smoke's own bounds.
"""

import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuahn_vio.data import sensor_effects as jfx
from cuahn_vio.data import textures as jtex
from cuahn_vio.ops.quat import quat_exp as jquat_exp
from cuahn_vio.ops.quat import quat_mul as jquat_mul
from cuahn_vio.train import trainer as jtrain
from cuahn_vio_torch.data import textures as ttex
from cuahn_vio_torch.data.synthetic import ground_points
from cuahn_vio_torch.models.uahn import init_uahn
from cuahn_vio_torch.train import trainer as ttrain
from cuahn_vio_torch.utils import prng
from cuahn_vio_torch.utils.config import VioOptions

# the suite runs in several worker processes: keep torch to a few threads
torch.set_num_threads(2)

H, W, B = 56, 80, 4
N_DRAWS = 8  # samples whose draws are compared
NORMAL_TOL = 2.4e-7  # of a unit normal
DERIVED_TOL = 1e-6
FLOW_TOL_PX = 1e-4
NEAR_M = 20.0
FAR_REACH = 3  # px around the far ground left out of the frame comparison
BANK_PAIRS = 16


def _camera():
    t = np.asarray(VioOptions.uzhfpv_indoor45().t_imu_to_cam, np.float64)
    return (t[:3, :3].astype(np.float32),
            (-t[:3, :3].T @ t[:3, 3]).astype(np.float32))


@pytest.fixture(scope="module")
def bank():
    """Four procedural textures at uint8 levels: (port uint8, JAX float32
    k/255)."""
    levels = ttex.quantize_u8(np.stack(ttex._procedural_extras(128)[:4]))
    return (torch.as_tensor(np.stack([ttex.texture_u8(t) for t in levels])),
            jnp.asarray(levels))


@pytest.fixture(scope="module")
def pose_pairs():
    """A synthetic pose-pair bank (p1, q1, p2, q2), float32."""
    rng = np.random.default_rng(2)
    p1 = np.stack([rng.normal(0, 2, BANK_PAIRS), rng.normal(0, 2, BANK_PAIRS),
                   rng.uniform(0.8, 2.5, BANK_PAIRS)], 1)
    rv1 = np.concatenate([rng.normal(0, 0.1, (BANK_PAIRS, 2)),
                          rng.uniform(-np.pi, np.pi, (BANK_PAIRS, 1))], 1)
    q1 = np.asarray(jax.vmap(jquat_exp)(rv1.astype(np.float32)))
    p2 = p1 + rng.normal(0, 0.05, (BANK_PAIRS, 3))
    q2 = np.asarray(jax.vmap(jquat_mul)(q1, jax.vmap(jquat_exp)(
        rng.normal(0, 0.02, (BANK_PAIRS, 3)).astype(np.float32))))
    return tuple(np.array(x, np.float32) for x in (p1, q1, p2, q2))


CASES = {
    "photo-effects": dict(traj_pair_prob=0.0),
    "procedural": dict(use_textures=False, traj_pair_prob=0.0),
    "bank-big-baseline": dict(use_effects=False, traj_pair_prob=0.5, big_baseline_prob=0.5),
}


def _jax_draws(keys, cfg, n_tex: int, pairs):
    """The draws ``sample_pair`` makes at each sample key, as the port's
    ``PairDraws`` names them (raw normals, before their scale)."""
    out = {k: [] for k in ("height", "tilt", "yaw", "dp", "rv_d", "pick", "prior_noise",
                           "tex_params", "exposure", "params1", "params2", "sigma",
                           "prior_sigma", "coin", "bank_idx", "bank_yaw", "big", "stretch",
                           "freqs", "signs", "phases")}
    ecfg = jfx.EffectsConfig()
    for k in jnp.asarray(keys):
        ks = jax.random.split(k, 16)
        out["height"].append(jax.random.uniform(ks[0], minval=cfg.height_range[0],
                                                maxval=cfg.height_range[1]))
        out["tilt"].append(jax.random.normal(ks[1], (2,)))
        out["yaw"].append(jax.random.uniform(ks[2], (1,), minval=-np.pi, maxval=np.pi)[0])
        out["dp"].append(jax.random.normal(ks[3], (3,)))
        out["rv_d"].append(jax.random.normal(ks[4], (3,)))
        out["prior_noise"].append(jax.random.normal(ks[6], (4, 2)))
        out["prior_sigma"].append(jnp.exp(jax.random.uniform(
            ks[10], minval=jnp.log(cfg.prior_noise_lo), maxval=jnp.log(cfg.prior_noise_px))))
        if pairs is not None:
            out["coin"].append(jax.random.bernoulli(ks[11], cfg.traj_pair_prob))
            out["bank_idx"].append(jax.random.randint(ks[12], (), 0, pairs[0].shape[0]))
            out["bank_yaw"].append(jax.random.uniform(ks[13], minval=0.0, maxval=2 * np.pi))
        if cfg.big_baseline_prob > 0.0:
            out["big"].append(jax.random.bernoulli(ks[14], cfg.big_baseline_prob))
            out["stretch"].append(jax.random.uniform(ks[15], minval=cfg.big_baseline_scale[0],
                                                     maxval=cfg.big_baseline_scale[1]))
        if cfg.use_textures:
            out["pick"].append(jax.random.randint(ks[5], (), 0, n_tex))
            out["tex_params"].append(jtex.random_tex_params(ks[7], cfg.tex_scale_range))
            out["exposure"].append(jax.random.uniform(ks[8], maxval=cfg.exposure_frac_max))
            if cfg.use_effects:
                kp, kd, kg = jax.random.split(ks[9], 6)[:3]
                params = jfx.draw_params(kp, ecfg)
                out["params1"].append(params)
                out["sigma"].append(jax.random.uniform(kd, maxval=ecfg.defocus_sigma_max)
                                    * (params[1] != 1.0))
                drift = 1.0 + jax.random.normal(kg) * ecfg.gain_drift
                out["params2"].append(params.at[1].multiply(
                    jnp.where(params[1] == 1.0, 1.0, drift)))
        else:
            k1, k2, k3 = jax.random.split(ks[5], 3)
            out["freqs"].append(jax.random.uniform(k1, (24, 2), minval=0.5, maxval=14.0))
            out["signs"].append(jnp.sign(jax.random.normal(k3, (24, 2))))
            out["phases"].append(jax.random.uniform(k2, (24,), minval=0.0,
                                                    maxval=2 * jnp.pi))
    return {k: np.stack([np.asarray(x) for x in v]) for k, v in out.items() if v}


def _equal(got, want, name):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want).astype(got.dtype), err_msg=name)


def _normal(got, want, scale, name):
    np.testing.assert_allclose(got.numpy(), want * scale, atol=NORMAL_TOL * scale, rtol=0,
                               err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_draw_pairs_are_sample_pairs_draws(case, pose_pairs):
    cfg = ttrain.TrainConfig(**CASES[case])
    keys = prng.split(prng.split(prng.prng_key(4), 3)[1], N_DRAWS)  # step 0's kb of seed 4
    pairs = pose_pairs if cfg.traj_pair_prob > 0.0 else None
    tex_indices = torch.tensor([0, 1, 3]) if cfg.use_textures else None
    d = ttrain.draw_pairs(cfg, keys, "cpu", tex_indices,
                          None if pairs is None else tuple(map(torch.as_tensor, pairs)))
    j = _jax_draws(keys, cfg, 3, pairs)
    _normal(d.prior_noise, j["prior_noise"], 1.0, "prior noise")
    np.testing.assert_allclose(d.prior_sigma.numpy(), j["prior_sigma"], rtol=DERIVED_TOL,
                               err_msg="prior sigma")
    # the random pose, as sample_pair composes it (before the bank's and the stretch's)
    rv1 = np.concatenate([j["tilt"] * cfg.tilt_sigma, j["yaw"][:, None]], axis=1)
    q1 = np.asarray(jax.vmap(jquat_exp)(rv1))
    rv_d = j["rv_d"] * cfg.rot_sigma
    q2 = np.asarray(jax.vmap(jquat_mul)(q1, jax.vmap(jquat_exp)(rv_d)))
    p1 = np.stack([np.zeros(N_DRAWS), np.zeros(N_DRAWS), j["height"]], axis=1).astype(np.float32)
    dp = j["dp"] * cfg.trans_sigma
    p2 = p1 + dp
    if pairs is not None:
        _equal(d.from_bank, j["coin"], "bank coin")
        assert 0 < j["coin"].sum() < N_DRAWS
        idx, yaw = j["bank_idx"], j["bank_yaw"]
        cy, sy = np.cos(yaw), np.sin(yaw)
        rz = np.stack([np.stack([cy, -sy, 0 * cy], -1), np.stack([sy, cy, 0 * cy], -1),
                       np.stack([0 * cy, 0 * cy, 1 + 0 * cy], -1)], -2)
        q_yaw = np.asarray(jax.vmap(jquat_exp)(np.stack([0 * yaw, 0 * yaw, yaw], 1)))
        use = j["coin"][:, None]
        p1 = np.where(use, np.einsum("bij,bj->bi", rz, pairs[0][idx]), p1)
        q1 = np.where(use, np.asarray(jax.vmap(jquat_mul)(q_yaw, pairs[1][idx])), q1)
        p2 = np.where(use, np.einsum("bij,bj->bi", rz, pairs[2][idx]), p2)
        q2 = np.where(use, np.asarray(jax.vmap(jquat_mul)(q_yaw, pairs[3][idx])), q2)
        dp = p2 - p1
    else:
        np.testing.assert_array_equal(d.p1[:, 2].numpy(), j["height"])
        _normal(d.dp, j["dp"], cfg.trans_sigma, "dp")
        _normal(d.rv_d, j["rv_d"], cfg.rot_sigma, "rv_d")
    if cfg.big_baseline_prob > 0.0:
        assert 0 < j["big"].sum() < N_DRAWS
        dp = dp * np.where(j["big"], j["stretch"], 1.0)[:, None]
        p2 = p1 + dp
    for name, got, want in (("p1", d.p1, p1), ("q1", d.q1, q1), ("p2", d.p2, p2),
                            ("q2", d.q2, q2), ("dp", d.dp, dp)):
        np.testing.assert_allclose(got.numpy(), want, atol=DERIVED_TOL, rtol=0, err_msg=name)
    if cfg.use_textures:
        _equal(d.tex_idx, np.array([0, 1, 3])[j["pick"]], "texture pick")
        np.testing.assert_allclose(d.tex_params.numpy(), j["tex_params"], rtol=DERIVED_TOL,
                                   atol=1e-7, err_msg="texture transform")
        _equal(d.exposure_frac, j["exposure"], "exposure")
        if cfg.use_effects:
            for name in ("params1", "params2", "sigma"):
                got = getattr(d.effects, name).numpy()
                np.testing.assert_allclose(got, j[name], rtol=DERIVED_TOL, atol=1e-8,
                                           err_msg=name)
        else:
            assert d.effects is None
    else:
        freqs, signs, phases = d.waves
        _equal(freqs, j["freqs"], "ground frequencies")
        _equal(signs, j["signs"], "ground signs")
        _equal(phases, j["phases"], "ground phases")


def _near_ground_close(got, want, p, q, cam):
    """A frame against the JAX frame (levels) away from the far ground: the
    ground beyond NEAR_M of the camera, grown by FAR_REACH pixels (the
    defocus blur's and the blur taps' reach), is left out; the sky (where
    the ray misses the plane, which the effects chain lifts off 0) and the
    near ground are compared."""
    ground, lam = ground_points(torch.as_tensor(p), torch.as_tensor(q), *cam, H, W)
    dist = torch.linalg.vector_norm(ground - torch.as_tensor(p[:2]), dim=-1)
    far = ((lam > 0) & (dist >= NEAR_M)).numpy()
    grown = np.pad(far, FAR_REACH)
    grown = np.stack([grown[i:i + H, j:j + W] for i in range(2 * FAR_REACH + 1)
                      for j in range(2 * FAR_REACH + 1)]).any(axis=0)
    got, want = np.round(got * 255.0), np.round(want * 255.0)
    diff = np.abs(got - want)[~grown]
    assert diff.size > 0.5 * got.size
    assert diff.max() <= 1.0 and (diff == 0).mean() >= 0.999, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("case", list(CASES))
def test_make_batch_is_the_jax_make_batch(case, bank, pose_pairs):
    port_bank, jax_bank = bank
    jcfg = jtrain.TrainConfig(batch_size=B, blur_taps=2, **CASES[case])
    cfg = ttrain.TrainConfig(batch_size=B, blur_taps=2, **CASES[case])
    kb = prng.split(prng.split(prng.prng_key(4), 3)[1], 3)[0]  # a batch key
    c_rot_i, i_t_i2c = _camera()
    textured = cfg.use_textures
    pairs = pose_pairs if cfg.traj_pair_prob > 0.0 else None
    gen = jax.jit(lambda k: jtrain.make_batch(
        k, jnp.asarray(c_rot_i), jnp.asarray(i_t_i2c), jcfg, H, W,
        jax_bank if textured else None, jnp.array([0, 1, 3]) if textured else None,
        None if pairs is None else tuple(map(jnp.asarray, pairs))))
    ref = jax.tree.map(np.asarray, gen(jnp.asarray(kb)))
    cam = (torch.as_tensor(c_rot_i), torch.as_tensor(i_t_i2c))
    out = ttrain.make_batch(cfg, kb, *cam, H, W, port_bank if textured else None,
                            torch.tensor([0, 1, 3]) if textured else None,
                            None if pairs is None else tuple(map(torch.as_tensor, pairs)))
    np.testing.assert_allclose(out.gt_flow.numpy(), ref.gt_flow, atol=FLOW_TOL_PX, rtol=0)
    np.testing.assert_allclose(out.prior.numpy(), ref.prior, atol=FLOW_TOL_PX, rtol=0)
    np.testing.assert_array_equal(out.valid.numpy(), ref.valid)
    draws = ttrain.draw_pairs(cfg, prng.split(kb, B), "cpu",
                              torch.tensor([0, 1, 3]) if textured else None,
                              None if pairs is None else tuple(map(torch.as_tensor, pairs)))
    for i in range(B):
        for frame, (p, q) in enumerate(((draws.p1, draws.q1), (draws.p2, draws.q2))):
            got = (out.img1 if frame == 0 else out.img2)[i].numpy()
            want = (ref.img1 if frame == 0 else ref.img2)[i]
            _near_ground_close(got, want, p[i].numpy(), q[i].numpy(), cam)
    assert np.abs(out.img1.numpy() - out.img2.numpy()).mean() > 1e-3  # the pair moved


def test_probe_batch_is_the_jax_probes(bank, monkeypatch):
    """The held-out probe of 4 pairs: its batch is the JAX probe's
    (``split(PRNGKey(probe_seed), 4)`` on the held-out texture, no pair
    bank: the JAX ``make_batch`` of ``PRNGKey(probe_seed)``), and the
    port's ``make_probe_metric`` scores that batch."""
    port_bank, jax_bank = bank
    monkeypatch.setattr(ttrain, "texture_bank_u8", lambda dev: port_bank.to(dev))
    jcfg = jtrain.TrainConfig(blur_taps=2, batch_size=4)
    cfg = ttrain.TrainConfig(blur_taps=2, batch_size=4)
    c_rot_i, i_t_i2c = _camera()
    cam = (torch.as_tensor(c_rot_i), torch.as_tensor(i_t_i2c))
    held = ttex.heldout_indices(4)
    assert held.tolist() == [3]
    ref = jax.tree.map(np.asarray, jax.jit(lambda k: jtrain.make_batch(
        k, jnp.asarray(c_rot_i), jnp.asarray(i_t_i2c), jcfg, H, W, jax_bank,
        jnp.asarray(held), None))(jax.random.PRNGKey(20240817)))
    out = ttrain.make_batch(cfg, prng.prng_key(20240817), *cam, H, W, port_bank,
                            torch.as_tensor(held, dtype=torch.long))
    np.testing.assert_allclose(out.gt_flow.numpy(), ref.gt_flow, atol=FLOW_TOL_PX, rtol=0)
    np.testing.assert_allclose(out.prior.numpy(), ref.prior, atol=FLOW_TOL_PX, rtol=0)
    np.testing.assert_array_equal(out.valid.numpy(), ref.valid)
    draws = ttrain.draw_pairs(cfg, prng.split(prng.prng_key(20240817), 4), "cpu",
                              torch.as_tensor(held, dtype=torch.long))
    for i in range(4):
        _near_ground_close(out.img1[i].numpy(), ref.img1[i], draws.p1[i].numpy(),
                           draws.q1[i].numpy(), cam)
    # the probe scores this batch: its error is the one of these frames
    model = init_uahn(prng.prng_key(2), H, W, device="cpu")
    got = ttrain.make_probe_metric(model, *cam, cfg, H, W, probe_size=4)(model)
    drop = prng.keys_tensor(np.repeat(prng.mask_keys(prng.prng_key(20240817 + 1))[None], 4,
                                      axis=0))
    pred, _ = model(out.img1, out.img2, out.prior, True, dropout_keys=drop)
    err = torch.linalg.vector_norm((pred - out.gt_flow).reshape(-1, 4, 2), dim=-1).reshape(-1)
    w = out.valid.repeat_interleave(4)
    want = torch.sum(err * w) / torch.clamp(w.sum(), min=1.0)
    assert math.isfinite(float(got[0])) and torch.equal(got[0], want)


def test_the_smokes_draw_references_are_the_ports_draws():
    """``chip_smoke.py``'s references of phases 11 and 14
    (``tests/data/train_draws_jax.npz``, JAX's draws) against the port's
    draws of the same keys on the CPU (``chip_smoke.check_pair_draws``,
    ``check_window_draws``: uniform, Bernoulli and randint draws equal,
    the rest within ``chip_smoke.DRAW_TOL``); the plain version launches
    no kernel."""
    import chip_smoke
    from cuahn_vio_torch.train import fil

    pairs = chip_smoke.check_pair_draws(torch, "cpu")
    windows = chip_smoke.check_window_draws(
        torch, "cpu", fil.FilConfig(window=chip_smoke.FIL_WINDOW, batch_size=chip_smoke.FIL_BATCH))
    assert pairs["batch_launches"] == 0 and not windows["fil_launches_by_mode"]
    for found in (pairs["step0"], pairs["probe"], windows):
        assert 0.0 < found["max_abs_diff_from_jax"] <= chip_smoke.DRAW_TOL
