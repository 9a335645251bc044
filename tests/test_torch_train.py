"""The port's trainer (``cuahn_vio_torch.train``) and what it runs on,
against the JAX package on the CPU, at the JAX tests' tiny model size
(``UAHN(img_height=56, img_width=80)``), both packages with the same
weights (``params_from_numpy``).

Tolerances:
- oracle: ``true_corner_flow`` within 1e-4 px;
- draws: the port's texture transforms and effects parameters of a key
  (``random_tex_params``, ``draw_effects_pair``) against the JAX package's
  of the same key within 1e-6 relative + 1e-7 absolute (the same bits;
  float32 rounding of exp, cos, sin and the offset's normal);
- effects: ``apply_photometric`` and ``apply_effects_pair`` at zero read
  and shot noise within 1e-6 absolute;
- a rendered training pair (the same poses, tex params and effects
  parameters through the port's ``render_pairs`` and through JAX's
  ``render_frame_blurred`` + ``apply_photometric`` + rounding): where the
  ground lies within 20 m of the camera, at least 99.9 % of the pixels at
  the same uint8 level and none more than one apart (the bound of
  ``tests/test_torch_textures.py``); the sky equal;
- ``cascade_flows`` within 1e-4 px;
- the loss within 1e-5 relative; every gradient leaf within 1e-3 of that
  leaf's max |g| (the JAX model warps with ``homography_warp_mm``, the port
  with the Pallas kernels' arithmetic); with one non-finite sample: the
  losses within 1e-5 relative and finite, and the gradients non-finite in
  the same leaves and entries (see the test for the one exception at this
  size);
- the optimizer: the parameters after each of 5 updates within 1e-6
  relative of optax's, the same skip counts; the schedule within 1e-6
  relative of optax's at every step of a 50-step run;
- checkpoints: arrays equal bit for bit both ways.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cuahn_vio.data import oracle as joracle
from cuahn_vio.data import sensor_effects as jfx
from cuahn_vio.data import textures as jtex
from cuahn_vio.data.synthetic import render_frame_blurred as jax_render_blurred
from cuahn_vio.models.uahn import UAHN as JaxUAHN
from cuahn_vio.models.uahn import init_uahn
from cuahn_vio.ops.quat import quat_exp as jquat_exp
from cuahn_vio.ops.quat import quat_mul as jquat_mul
from cuahn_vio.train import trainer as jtrain
from cuahn_vio.utils import checkpoint as jckpt
from cuahn_vio_torch.data import oracle as toracle
from cuahn_vio_torch.data import sensor_effects as tfx
from cuahn_vio_torch.data import textures as ttex
from cuahn_vio_torch.data.synthetic import ground_points
from cuahn_vio_torch.models.uahn import UAHN
from cuahn_vio_torch.ops.warp import homography_warp
from cuahn_vio_torch.train import trainer as ttrain
from cuahn_vio_torch.utils import checkpoint as tckpt
from cuahn_vio_torch.utils import prng
from cuahn_vio_torch.utils.config import VioOptions

# the suite runs in several worker processes: keep torch to a few threads
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, B = 56, 80, 4
FLOW_TOL_PX = 1e-4
FX_TOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-3  # of the leaf's max |g|
OPT_RTOL = 1e-6
NEAR_M = 20.0  # ground within this of the camera: rendered frames compared there
RENDER_KEY = 26  # PRNGKey of the rendered pairs' draws: a pair that sees the horizon


def _camera():
    t = np.asarray(VioOptions.uzhfpv_indoor45().t_imu_to_cam, np.float64)
    return (t[:3, :3].astype(np.float32),
            (-t[:3, :3].T @ t[:3, 3]).astype(np.float32))


@pytest.fixture(scope="module")
def jax_params():
    _, params = init_uahn(jax.random.PRNGKey(0), img_height=H, img_width=W)
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def models(jax_params):
    """The flax model and the port's, the same weights, dropout off."""
    port = UAHN(dropout_rate=0.0, img_height=H, img_width=W)
    port.load_state_dict(tckpt.params_from_numpy(jax_params))
    return JaxUAHN(img_height=H, img_width=W, dropout_rate=0.0), port


def _pair_images(rng, b=B):
    base = rng.integers(0, 256, (b, H + 8, W + 8)).astype(np.float32) / 255.0
    return base[:, 4:4 + H, 4:4 + W].copy(), base[:, 2:2 + H, 3:3 + W].copy()


@pytest.fixture(scope="module")
def batch_np():
    """Batch 4 from numpy: shifted noise frames at uint8 levels, small
    flows with a prior, sample 2 invalid (a flow beyond max_flow_px)."""
    rng = np.random.default_rng(0)
    img1, img2 = _pair_images(rng)
    gt = rng.normal(0, 3, (B, 8)).astype(np.float32)
    gt[2, 3] = 150.0
    prior = (gt.reshape(B, 4, 2) + rng.normal(0, 2, (B, 4, 2))).astype(np.float32)
    valid = np.all(np.abs(gt) < ttrain.TrainConfig().max_flow_px, axis=1).astype(np.float32)
    assert valid.tolist() == [1, 1, 0, 1]
    return img1, img2, gt, prior, valid


def _random_poses(rng, n):
    p1 = np.stack([rng.normal(0, 0.3, n), rng.normal(0, 0.3, n), rng.uniform(0.8, 3.0, n)], 1)
    rv1 = np.concatenate([rng.normal(0, 0.12, (n, 2)), rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    dp = rng.normal(0, 0.06, (n, 3)) * rng.uniform(1, 4, (n, 1))
    rv_d = rng.normal(0, 0.025, (n, 3))
    return [x.astype(np.float32) for x in (p1, rv1, dp, rv_d)]


def test_true_corner_flow_matches_jax():
    rng = np.random.default_rng(1)
    p1, rv1, dp, rv_d = _random_poses(rng, 32)
    q1 = np.asarray(jax.vmap(jquat_exp)(rv1))
    q2 = np.asarray(jax.vmap(jquat_mul)(q1, jax.vmap(jquat_exp)(rv_d)))
    c_rot_i, i_t_i2c = _camera()
    ref = jax.vmap(lambda a, b, c, d: joracle.true_corner_flow(
        a, b, c, d, jnp.asarray(c_rot_i), jnp.asarray(i_t_i2c)))(p1, q1, p1 + dp, q2)
    out = toracle.true_corner_flow(*(torch.as_tensor(x) for x in (p1, q1, p1 + dp, q2,
                                                                  c_rot_i, i_t_i2c)))
    assert out.shape == (32, 8)
    assert np.abs(np.asarray(ref)).max() > 20.0  # real flows, not near zero
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FLOW_TOL_PX, rtol=0)


def test_tex_and_effects_parameters_from_jax_draws():
    """The port's texture transforms and effects parameters of 64 keys,
    one sampler call a field, against the JAX package's own functions of
    each key (the same bits; exp, cos and sin within float32 rounding)."""
    keys = prng.split(prng.prng_key(3), 64)
    cfg = jfx.EffectsConfig()
    ref_tex, ref_fx, ref_sigma, ref_p2 = [], [], [], []
    for key in jnp.asarray(keys):
        ref_tex.append(np.asarray(jtex.random_tex_params(key)))
        # sensor_effects.apply_effects_pair's draws
        kp, kd, kg = jax.random.split(key, 6)[:3]
        params = jfx.draw_params(kp, cfg)
        ref_fx.append(np.asarray(params))
        ref_sigma.append(np.asarray(jax.random.uniform(kd, maxval=cfg.defocus_sigma_max)
                                    * (params[1] != 1.0)))
        drift = 1.0 + jax.random.normal(kg) * cfg.gain_drift
        ref_p2.append(np.asarray(params.at[1].multiply(jnp.where(params[1] == 1.0, 1.0,
                                                                 drift))))
    tex = ttex.random_tex_params(keys, "cpu")
    np.testing.assert_allclose(tex.numpy(), np.array(ref_tex), rtol=1e-6, atol=1e-7)
    tcfg = tfx.EffectsConfig()
    draw = tfx.draw_effects_pair(tcfg, keys, "cpu")
    fx = draw.params1
    np.testing.assert_allclose(fx.numpy(), np.array(ref_fx), rtol=1e-6, atol=1e-7)
    assert 0 < (fx[:, 1] == 1.0).sum() < len(keys)  # clean and degraded samples both
    np.testing.assert_allclose(draw.sigma.numpy(), np.array(ref_sigma), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(draw.params2.numpy(), np.array(ref_p2), rtol=1e-6, atol=1e-7)
    assert torch.equal(tfx.draw_params(tcfg, prng.split(keys, 6)[:, 0], "cpu"), fx)


@pytest.fixture(scope="module")
def smooth_frames():
    """Four 56x80 frames in [0, 1] with structure at several scales."""
    rng = np.random.default_rng(4)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    frames = [0.5 + 0.25 * np.sin(x * f1 + y * f2 + ph) + 0.2 * rng.random((H, W))
              for f1, f2, ph in rng.uniform(0.05, 0.6, (4, 3))]
    return np.clip(np.stack(frames), 0.0, 1.0).astype(np.float32)


def test_apply_photometric_matches_jax_without_noise(smooth_frames):
    params = np.array([[0.3, 1.3, 0.8, 0.01, 0.0, 0.0],
                       [0.0, 1.0, 1.0, 0.0, 0.0, 0.0],
                       [0.1, 0.7, 1.25, -0.02, 0.0, 0.0],
                       [0.2, 1.1, 0.9, 0.005, 0.0, 0.0]], np.float32)
    sigma = np.array([1.2, 0.0, 0.005, 0.6], np.float32)  # blur, none, under 0.01, blur
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    ref = jax.vmap(jfx.apply_photometric)(smooth_frames, keys, params, sigma)
    noise = torch.randn((2, *smooth_frames.shape))  # times zero read/shot sigma
    out = tfx.apply_photometric(torch.as_tensor(smooth_frames), torch.as_tensor(params),
                                torch.as_tensor(sigma), noise)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FX_TOL, rtol=0)
    assert not np.array_equal(out.numpy()[0], smooth_frames[0])


def test_apply_effects_pair_matches_jax_without_noise(smooth_frames):
    """JAX's apply_effects_pair with its own draws (no read or shot noise)
    against the port's draws of the same keys: parameters, defocus and
    drift (``draw_effects_pair``), and the frames' noise (``draw_noise``
    of ``noise_keys``, which zero sigmas scale away)."""
    cfg = jfx.EffectsConfig(read_noise_max=0.0, shot_noise_max=0.0)
    tcfg = tfx.EffectsConfig(read_noise_max=0.0, shot_noise_max=0.0)
    img1, img2 = smooth_frames[:2], smooth_frames[2:]
    keys = prng.split(prng.prng_key(6), 2)
    ref1, ref2 = jax.vmap(lambda a, b, k: jfx.apply_effects_pair(a, b, k, cfg))(
        img1, img2, jnp.asarray(keys))
    draw = tfx.draw_effects_pair(tcfg, keys, "cpu")
    noise = tfx.draw_noise(tfx.noise_keys(keys), (H, W), "cpu")
    assert noise.shape == (2, 2, 2, H, W)
    out1, out2 = tfx.apply_effects_pair(torch.as_tensor(img1), torch.as_tensor(img2), draw,
                                        noise[:, 0], noise[:, 1])
    np.testing.assert_allclose(out1.numpy(), np.asarray(ref1), atol=FX_TOL, rtol=0)
    np.testing.assert_allclose(out2.numpy(), np.asarray(ref2), atol=FX_TOL, rtol=0)


def test_rendered_pair_matches_jax():
    """Two full-size photo-texture pairs from the port's draws (effects at
    zero read and shot noise), through ``render_pairs`` and through the JAX
    trainer's steps (blur taps, ``render_frame_blurred``,
    ``apply_photometric``, rounding to uint8 levels), compared where the
    ground lies within NEAR_M of the camera (and on the sky, 0 in both).
    A pair of RENDER_KEY's looks over the horizon (the 45 deg camera,
    tilted further): beyond ~50 m a float32 rounding of the ray's angle moves
    its ground point by a sizable part of a texel at these grazing angles,
    and the two packages' renders of that far ground differ by up to tens
    of levels; both are float32 noise of an aliased texture there."""
    hgt, wid, b = 224, 320, 2
    cfg = ttrain.TrainConfig()
    bank = ttex.get_texture_bank()
    bank_u8 = torch.as_tensor(np.stack([ttex.texture_u8(t) for t in bank[:12]]))
    draws = ttrain.draw_pairs(cfg, prng.split(prng.prng_key(RENDER_KEY), b), "cpu",
                              torch.arange(12))
    fx = draws.effects
    quiet = [p.clone() for p in (fx.params1, fx.params2)]
    for p in quiet:
        p[:, 4:] = 0.0  # no read or shot noise
    fx = fx._replace(params1=quiet[0], params2=quiet[1],
                     sigma=torch.tensor([0.7, 0.0]))  # one pair defocused
    draws = draws._replace(effects=fx)
    c_rot_i, i_t_i2c = _camera()
    noise = tuple(torch.zeros((2, b, hgt, wid)) for _ in range(2))
    out = ttrain.render_pairs(draws, cfg, torch.as_tensor(c_rot_i), torch.as_tensor(i_t_i2c),
                              hgt, wid, bank_u8, noise)
    d = {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in draws._asdict().items()}
    key = jax.random.PRNGKey(0)
    horizon = False
    for i in range(b):
        betas = jnp.linspace(-1.0, 0.0, cfg.blur_taps) * d["exposure_frac"][i]
        for frame, (p, q, params) in enumerate([(d["p1"], d["q1"], quiet[0]),
                                                (d["p2"], d["q2"], quiet[1])]):
            ps = p[i][None] + betas[:, None] * d["dp"][i][None]
            qs = jax.vmap(lambda bb: jquat_mul(q[i], jquat_exp(bb * d["rv_d"][i])))(betas)
            img = jax_render_blurred(ps, qs, jnp.asarray(c_rot_i), jnp.asarray(i_t_i2c), None,
                                     hgt, wid, jnp.asarray(bank[d["tex_idx"][i]]),
                                     jnp.asarray(d["tex_params"][i]))
            img = jfx.apply_photometric(img, key, jnp.asarray(params[i].numpy()),
                                        float(fx.sigma[i]))
            ref = np.round(np.clip(np.asarray(img), 0.0, 1.0) * 255.0)
            got = np.round((out.img1 if frame == 0 else out.img2)[i].numpy() * 255.0)
            ground, lam = ground_points(torch.as_tensor(p[i]), torch.as_tensor(q[i]),
                                        torch.as_tensor(c_rot_i), torch.as_tensor(i_t_i2c))
            dist = torch.linalg.vector_norm(ground - torch.as_tensor(p[i][:2]), dim=-1)
            near = ((lam > 0) & (dist < NEAR_M)).numpy()
            sky = (lam <= 0).numpy()
            assert near.mean() > 0.85
            assert (got[sky] == ref[sky]).all()
            diff = np.abs(got - ref)[near]
            assert diff.max() <= 1.0, (i, frame, diff.max())
            assert (diff == 0).mean() >= 0.999, (i, frame, (diff > 0).mean())
            assert ref.std() > 10.0  # a textured frame, not a blank one
            horizon |= bool(sky.any())
    assert horizon  # the far-ground case is really exercised
    assert np.array_equal(np.round(out.img1.numpy() * 255.0) / 255.0, out.img1.numpy())


@pytest.mark.parametrize("use_prior", [True, False])
def test_cascade_flows_matches_jax(models, jax_params, smooth_frames, use_prior):
    jm, port = models
    prior = np.random.default_rng(8).normal(0, 2, (2, 4, 2)).astype(np.float32)
    img1, img2 = smooth_frames[:2], smooth_frames[2:]
    ref_flows, ref_h = jax.vmap(lambda a, b, p: jm.apply(
        {"params": jax_params}, a, b, p if use_prior else None, use_prior,
        method=JaxUAHN.cascade_flows))(img1, img2, prior)
    flows, h = port.cascade_flows(torch.as_tensor(img1), torch.as_tensor(img2),
                                  torch.as_tensor(prior), use_prior)
    assert flows.shape == ref_flows.shape == (2, 2 if use_prior else 3, 8)
    np.testing.assert_allclose(flows.detach().numpy(), np.asarray(ref_flows),
                               atol=FLOW_TOL_PX, rtol=0)
    assert h.requires_grad  # the last block's DLT is differentiable


def _losses_and_grads(models, jax_params, batch, use_prior, echo):
    """(JAX loss, aux, grads as a port state dict; port loss, aux, grads)."""
    jm, port = models
    jcfg = jtrain.TrainConfig(echo_weight=echo)
    jb = jtrain.Batch(*(jnp.asarray(x) for x in batch))
    (loss, aux), grads = jax.value_and_grad(jtrain.make_loss_fn(jm, jcfg), has_aux=True)(
        jax_params, jb, jax.random.PRNGKey(1), use_prior)
    port.zero_grad(set_to_none=True)
    tloss, taux = ttrain.make_loss_fn(port, ttrain.TrainConfig(echo_weight=echo))(
        ttrain.Batch(*(torch.as_tensor(x) for x in batch)), use_prior, None)
    tloss.backward()
    tgrads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
              for n, p in port.named_parameters()}
    ref = {n: g.numpy() for n, g in
           tckpt.params_from_numpy(jax.tree.map(np.asarray, grads)).items()}
    return (float(loss), np.asarray(aux), ref), (tloss.item(), taux.detach().numpy(), tgrads)


@pytest.mark.parametrize("use_prior", [True, False])
@pytest.mark.parametrize("echo", [0.0, 0.5])
def test_loss_and_gradients_match_jax(models, jax_params, batch_np, use_prior, echo):
    (loss, aux, ref), (tloss, taux, grads) = _losses_and_grads(
        models, jax_params, batch_np, use_prior, echo)
    assert np.isfinite(loss)
    np.testing.assert_allclose(tloss, loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(taux, aux, rtol=LOSS_RTOL)
    assert ref.keys() == grads.keys()
    for name, g in ref.items():
        assert np.isfinite(grads[name]).all(), name
        scale = np.abs(g).max()
        if use_prior and name.split(".")[0] in ("block1", "fc_block1"):
            assert scale == 0.0 and not grads[name].any()  # block 1 does not run
            continue
        assert scale > 0.0, name
        np.testing.assert_allclose(grads[name], g, atol=GRAD_TOL * scale, rtol=0,
                                   err_msg=name)


def test_nonfinite_sample_is_masked_like_jax(models, jax_params, batch_np):
    """Sample 1's prior puts all four corners on one point: its DLT is
    singular and its loss non-finite. Both trainers drop it from the loss
    (which stays finite and equal), and their gradients are non-finite in
    the same leaves and entries, so optax's apply_if_finite and the port's
    optimizer skip the step alike. The one exception is an artefact of the
    tiny size: each tower's last conv gets a 2-row map and makes one output
    row, so its kernel's first row reads only zero padding; XLA's weight
    gradient multiplies that padding by the NaN cotangent, oneDNN's leaves
    the padding out, so there the port's first kernel row stays finite."""
    img1, img2, gt, prior, valid = batch_np
    prior = prior.copy()
    corners = np.array([[0, 0], [0, H - 1], [W - 1, H - 1], [W - 1, 0]], np.float32)
    prior[1] = np.array([W / 2, H / 2], np.float32) - corners
    (loss, aux, ref), (tloss, taux, grads) = _losses_and_grads(
        models, jax_params, (img1, img2, gt, prior, valid), True, 0.5)
    assert np.isfinite(loss) and np.isfinite(tloss)
    np.testing.assert_allclose(tloss, loss, rtol=LOSS_RTOL)
    last_convs = {"block2.conv3.weight", "block3.conv5.weight", "block4.conv6.weight"}
    nonfinite_leaves = 0
    for name, g in ref.items():
        want, got = np.isfinite(g), np.isfinite(grads[name])
        nonfinite_leaves += not want.all()
        assert want.all() == got.all(), name
        if name in last_convs:
            assert not want.any() and not got[:, :, 1:].any(), name
        else:
            assert np.array_equal(want, got), name
    assert nonfinite_leaves > 10


def test_optimizer_matches_optax():
    """The same gradient trees, one of them with a NaN, through optax's
    chain (the JAX trainer's ``make_optimizer``) and the port's
    ``OptaxAdamW``, for 5 updates; the gradients' global norm is above the
    clip on some steps and under it on others."""
    rng = np.random.default_rng(9)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    params = {k: rng.normal(0, 0.5, s).astype(np.float32) for k, s in shapes.items()}
    scales = [0.05, 2.0, 0.2, 1.0, 0.3]
    grads = [{k: (rng.normal(0, sc, s)).astype(np.float32) for k, s in shapes.items()}
             for sc in scales]
    grads[2]["b"][3] = np.nan
    cfg = jtrain.TrainConfig(lr=1e-2, warmup_steps=2, weight_decay=1e-2)
    steps = 5
    sched = optax.warmup_cosine_decay_schedule(0.0, cfg.lr, cfg.warmup_steps,
                                               max(steps, cfg.warmup_steps + 1),
                                               end_value=cfg.lr * 0.05)
    tx = jtrain.make_optimizer(cfg, sched)
    jp, state = dict(params), tx.init(params)
    tensors = [torch.tensor(params[k]) for k in sorted(shapes)]

    class Holder(torch.nn.Module):  # make_optimizer takes a module's parameters
        def __init__(self):
            super().__init__()
            self.p = torch.nn.ParameterList([torch.nn.Parameter(t) for t in tensors])

    holder = Holder()
    tcfg = ttrain.TrainConfig(lr=1e-2, warmup_steps=2, weight_decay=1e-2)
    opt = ttrain.make_optimizer(holder, tcfg, steps)
    skips = []
    for g in grads:
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, k in zip(holder.p, sorted(shapes)):
            p.grad = torch.tensor(g[k])
        opt.step()
        for p, k in zip(holder.p, sorted(shapes)):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=OPT_RTOL,
                                       atol=1e-9)
        assert int(opt.notfinite_count) == int(state.notfinite_count)
        assert int(opt.total_notfinite) == int(state.total_notfinite)
        skips.append(int(opt.notfinite_count))
    assert skips == [0, 0, 1, 0, 0]
    assert not np.allclose(holder.p[0].detach().numpy(), params["a"])


def test_schedule_matches_optax():
    sched = optax.warmup_cosine_decay_schedule(0.0, 2e-4, 10, 50, end_value=1e-5)
    counts = np.arange(0, 60)
    ref = np.array([float(sched(c)) for c in counts])
    out = ttrain.warmup_cosine_decay(torch.tensor(counts, dtype=torch.int32), 0.0, 2e-4, 10,
                                     50, end_value=1e-5)
    assert out.dtype == torch.float32 and float(out[0]) == 0.0
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-12)


def test_train_is_seeded_and_flips_modes_like_jax():
    """Two port runs of 2 steps at one seed end with identical parameters;
    the prior-mode coin of a 6-step run is the JAX trainer's, read from its
    own loop (``cuahn_vio.train.trainer.train``) with its batch and step
    functions stubbed out."""
    cfg = ttrain.TrainConfig(batch_size=2, blur_taps=2, traj_pair_prob=0.0)
    c_rot_i, i_t_i2c = (torch.as_tensor(x) for x in _camera())

    def run(steps, log):
        model = UAHN(img_height=H, img_width=W)
        model.load_state_dict(runs_init)
        ttrain.train(model, c_rot_i, i_t_i2c, cfg, steps=steps, seed=11, log_every=1,
                     height=H, width=W, probe_every=0, log_fn=lambda m, **_: log.append(m))
        return model.state_dict()

    runs_init = UAHN(img_height=H, img_width=W).state_dict()
    a, b = run(2, []), run(2, [])
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], runs_init[k]) for k in a)

    log = []
    run(6, log)
    port_modes = [m.split("prior=")[1].split()[0] == "True" for m in log if "prior=" in m]

    jax_modes = []

    def fake_step_maker(model, cfg, tx):
        def step(params, opt_state, batch, key, use_prior):
            jax_modes.append(use_prior)
            return params, opt_state, 0.0, (0.0, 0.0, 0.0)
        return step

    def fake_batch(*args, **kwargs):
        z = jnp.zeros((1,))
        return jtrain.Batch(img1=z, img2=z, gt_flow=z, prior=z, valid=z)

    saved = jtrain.make_train_step, jtrain.make_batch
    jtrain.make_train_step, jtrain.make_batch = fake_step_maker, fake_batch
    try:
        jtrain.train(JaxUAHN(), {}, jnp.eye(3), jnp.zeros(3),
                     # a batch the 8 test devices do not divide: no mesh
                     jtrain.TrainConfig(batch_size=3, use_textures=False, traj_pair_prob=0.0),
                     steps=6, seed=11, log_every=0)
    finally:
        jtrain.make_train_step, jtrain.make_batch = saved
    assert port_modes == jax_modes and len(jax_modes) == 6
    assert 0 < sum(jax_modes) < 6


def test_warp_refuses_tensors_that_require_grad():
    imgs = torch.rand(2, 8, 10)
    hs = torch.eye(3).repeat(2, 1, 1)
    for args in ((imgs.clone().requires_grad_(), hs), (imgs, hs.clone().requires_grad_())):
        with pytest.raises(ValueError, match="no backward"):
            homography_warp(*args)
    assert homography_warp(imgs, hs).shape == (2, 8, 10)


def test_port_checkpoints_read_in_jax_and_back(jax_params, tmp_path):
    """Port-written -> JAX ``load_params``, and JAX ``save_params`` -> the
    port's reader, arrays equal bit for bit."""
    model = UAHN(img_height=H, img_width=W)
    state = model.state_dict()
    path = str(tmp_path / "port.msgpack")
    tckpt.save_params(path, state)
    loaded = jckpt.load_params(path, jax_params)
    back = tckpt.params_from_numpy(jax.tree.map(np.asarray, loaded))
    assert back.keys() == state.keys()
    assert all(torch.equal(back[k], state[k]) for k in state)

    jax_path = str(tmp_path / "jax.msgpack")
    jckpt.save_params(jax_path, jax_params)
    ours = tckpt.load_params(jax_path)
    want = tckpt.params_from_numpy(jax_params)
    assert all(torch.equal(ours[k], want[k]) for k in want)
    flat_ours = jax.tree.leaves(tckpt.params_to_numpy(ours))
    assert all(a.tobytes() == np.asarray(b).tobytes()
               for a, b in zip(flat_ours, jax.tree.leaves(jax_params)))


@pytest.mark.parametrize("tree", [
    {"empty": np.zeros((0,), np.float32), "one": np.ones((1,), np.uint8)},
    {"fixext 16": np.ones((1,), np.float32), "k" * 40: np.arange(7.0, dtype=np.float32)},
    {k: {"bias": np.full((len(k),), 1, np.float32)} for k in sorted(map(str, range(17)))},
    {"conv": np.ones((7, 7, 2, 128), np.float32), "dense": np.ones((5120, 256), np.float32)},
], ids=["tiny", "fixext and str8", "map16", "kernels"])
def test_msgpack_writer_is_flaxs_format(tree):
    """The port's encoder writes what ``flax.serialization`` writes, byte
    for byte, at the format's size thresholds (keys in sorted order, as
    Flax's tree flattening leaves them and ``params_to_numpy`` makes
    them)."""
    from flax import serialization

    from cuahn_vio_torch.utils.msgpack_reader import unpackb
    from cuahn_vio_torch.utils.msgpack_writer import packb

    data = packb(tree)
    assert data == serialization.msgpack_serialize(tree)
    back = unpackb(data)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back),
                                                    jax.tree.leaves(tree)))


def test_shipped_weights_round_trip_byte_for_byte(tmp_path):
    """save_params(load_params(v9)) reloads to the same arrays, and its
    bytes are the file's (keys sorted, each value in msgpack's shortest
    form, as Flax writes). v9 is not committed; where it is absent, the
    committed v10 (the same tree) stands in."""
    src = os.path.join(REPO, "weights", "uahn_tex_v9.msgpack")
    if not os.path.exists(src):
        src = os.path.join(REPO, "weights", "uahn_fil_v10.msgpack")
    state = tckpt.load_params(src)
    out = str(tmp_path / "again.msgpack")
    tckpt.save_params(out, state)
    again = tckpt.load_params(out)
    assert all(torch.equal(again[k], state[k]) for k in state)
    with open(src, "rb") as f, open(out, "rb") as g:
        assert f.read() == g.read()


def test_cli_train_uahn_writes_weights_jax_reads(tmp_path):
    """``train-uahn`` on the CPU at 224x320 (no textures: no probe) writes a
    checkpoint that JAX's ``load_params`` fills ``init_uahn``'s tree from."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "cuahn_vio_torch.cli", "train-uahn", "--device", "cpu",
         "--steps", "2", "--batch-size", "2", "--no-textures", "--no-effects", "--out",
         "w.msgpack"], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert sum(line.startswith("step") for line in lines) == 2
    assert "random poses" in proc.stdout and "wrote weights" in lines[-1]
    template = jax.eval_shape(lambda: init_uahn(jax.random.PRNGKey(0))[1])
    loaded = jckpt.load_params(str(tmp_path / "w.msgpack"), template)
    shapes = jax.tree.map(lambda x: x.shape, template)
    assert jax.tree.map(lambda x: np.asarray(x).shape, loaded) == shapes
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(loaded))


def test_make_synthetic_effects_follows_the_jax_chain():
    """``make_sequence(effects=...)``: one draw of the chain's parameters and
    defocus for the sequence (the JAX package's draws from
    ``PRNGKey(effects_seed)``), the JAX package's numpy gain-drift walk,
    per-frame noise. At zero read and shot noise each frame is the JAX
    ``apply_photometric`` of the sharp frame under those parameters, within
    one uint8 level on every pixel and at the same level on at least 99.9 %
    of them. Effects seed 3: a draw that is not the clean one (2, 5, 6 and
    8 are)."""
    from cuahn_vio_torch.data.synthetic import (
        AnalyticTrajectory,
        exposure_taps,
        make_sequence,
        render_frame_blurred,
        texture_draws,
    )

    t_ic = np.asarray(VioOptions().t_imu_to_cam, np.float64)
    cfg = tfx.EffectsConfig(read_noise_max=0.0, shot_noise_max=0.0)
    kw = dict(duration=0.3, seed=2, device="cpu")
    seq = make_sequence(AnalyticTrajectory(), t_ic, effects=cfg, effects_seed=3, **kw)
    clean = make_sequence(AnalyticTrajectory(), t_ic, **kw)
    k_par, k_sig, _ = jax.random.split(jax.random.PRNGKey(3), 3)
    params = tfx.draw_params(cfg, np.asarray(k_par)[None], "cpu")[0].numpy()
    defocus = float(jax.random.uniform(k_sig, maxval=cfg.defocus_sigma_max))
    drift = np.clip(np.cumsum(np.random.default_rng(3).normal(
        0.0, cfg.gain_drift / 5.0, len(seq.cam_t))), -0.25, 0.25).astype(np.float32)
    c_rot_i = torch.tensor(t_ic[:3, :3], dtype=torch.float32)
    i_t_i2c = torch.tensor(-t_ic[:3, :3].T @ t_ic[:3, 3], dtype=torch.float32)
    waves = [torch.as_tensor(x) for x in texture_draws(0)]  # texture_seed 0
    p, q = exposure_taps(AnalyticTrajectory(), seq.cam_t - 2.5, 0.0, "cpu")
    for i in range(len(seq.cam_t)):
        sharp = render_frame_blurred(p[i], q[i], c_rot_i, i_t_i2c, waves)
        ref = jfx.apply_photometric(jnp.asarray(sharp.numpy()), jax.random.PRNGKey(0),
                                    jnp.asarray(params).at[1].multiply(1.0 + drift[i]),
                                    defocus)
        want = np.clip(np.asarray(ref) * 255.0, 0, 255).astype(np.uint8).astype(int)
        assert np.abs(seq.frames[i].astype(int) - want).max() <= 1
        assert (seq.frames[i] == want).mean() >= 0.999
    assert np.abs(seq.frames.astype(int) - clean.frames.astype(int)).mean() > 2.0
