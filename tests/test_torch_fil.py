"""The port's filter-in-the-loop fine-tune (``cuahn_vio_torch.train.fil``)
against ``cuahn_vio.train.fil`` on the CPU, at ``tests/test_fil.py``'s
tiny config (window 2, batch 2, 4 IMU intervals, one blur tap, 64x64
frames) with a 64x64 UAHN, both packages with the same random weights
(``params_from_numpy``) and MC dropout off.

The GT directory is a temporary one (``tests/test_torch_fil_bank.py``'s
``gt_dir``, where the window bank is compared: no test reads the
reference checkout).

The window loss is compared on the JAX package's own draws and rendered
uint8 frames: the test recomputes them from the JAX loss's key splits and
feeds them to the port's ``window_losses``, so the two differ only in the
filter and network arithmetic.

Tolerances:
- the loss within 1e-4 relative (measured 4.8e-7); every gradient leaf
  that JAX gives a non-zero gradient: cosine >= 0.9999 and norm within
  1e-3 relative (measured: cosine >= 1 - 1.2e-7, norms within 1.2e-5);
  the leaves that JAX gives none (blocks 1-3: the part-1 homography is a
  constant to backprop) none;
- the step schedule and the windows of each FIL step: equal to the JAX
  loop's.

``tests/test_torch_fil_keys.py`` holds the port's own draws of a step key
(``draw_windows``) and the loss of the key alone to the JAX window loss's.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuahn_vio.data import sensor_effects as jfx
from cuahn_vio.data import textures as jtex
from cuahn_vio.data.synthetic import render_frame_blurred as jax_render_blurred
from cuahn_vio.filter import make_params as jax_make_params
from cuahn_vio.models.uahn import UAHN as JaxUAHN
from cuahn_vio.pipeline.vio import VioConfig as JaxVioConfig
from cuahn_vio.train import fil as jfil
from cuahn_vio_torch import cli as tcli
from cuahn_vio_torch.data import textures as ttex
from cuahn_vio_torch.filter.state import make_params
from cuahn_vio_torch.models.uahn import UAHN
from cuahn_vio_torch.pipeline.vio import VioConfig
from cuahn_vio_torch.train import fil as tfil
from cuahn_vio_torch.utils import checkpoint as tckpt
from cuahn_vio_torch.utils import prng
from tests.test_propagate import T_ITOC
from tests.test_torch_fil_bank import CFG, gt_dir  # noqa: F401 (a fixture)

# the suite runs in several worker processes: keep torch to a few threads
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDE = 64
LOSS_RTOL = 1e-4
GRAD_COS = 0.9999
GRAD_NORM_RTOL = 1e-3


def _camera():
    t = np.asarray(T_ITOC, np.float64)
    return t[:3, :3].astype(np.float32), (-t[:3, :3].T @ t[:3, 3]).astype(np.float32)


def _tex_bank():
    """Four procedural textures at uint8 levels (128x128)."""
    return ttex.quantize_u8(np.stack(ttex._procedural_extras(128)[:4]))


def _jax_draws(cfg, win, key, tex_bank, tex_idx, c_rot_i, i_t_i2c):
    """The JAX window loss's draws and frames for one window, from its key
    splits (``cuahn_vio/train/fil.py`` window_loss): (uint8 frames, the
    normals in ``WindowDraws`` order from bias_g on, the other draws: the
    texture pick, its transform, the lens and the frames' read and shot
    normals)."""
    ks = jax.random.split(key, 10)
    idx = tex_idx[jax.random.randint(ks[0], (), 0, tex_idx.shape[0])]
    texture = tex_bank[idx]
    tparams = jtex.random_tex_params(ks[1], cfg.tex_scale_range)
    lens = jfx.draw_params(ks[2], jfx.EffectsConfig())

    def render_one(p_taps, q_taps, k):
        img = jax_render_blurred(p_taps, q_taps, c_rot_i, i_t_i2c, None, cfg.img_hw[0],
                                 cfg.img_hw[1], texture, tparams)
        img = jfx.apply_photometric(img, k, lens)
        return jnp.round(jnp.clip(img, 0.0, 1.0) * 255.0).astype(jnp.uint8)

    fkeys = jax.random.split(ks[3], win["tap_p"].shape[0])
    imgs = jax.vmap(render_one)(win["tap_p"], win["tap_q"], fkeys)
    ik = jax.random.split(ks[8], 5)
    normals = (jax.random.normal(ks[4], (3,)), jax.random.normal(ks[5], (3,)),
               jax.random.normal(ks[6], win["w_true"].shape),
               jax.random.normal(ks[7], win["a_true"].shape),
               jax.random.normal(ik[0], (2,)), jax.random.normal(ik[1], (3,)),
               jax.random.normal(ik[2], (3,)), jax.random.normal(ik[3], (3,)),
               jax.random.normal(ik[4], (3,)))
    hw = tuple(cfg.img_hw)
    noise = [[jax.random.normal(k, hw) for k in jax.random.split(fk)] for fk in fkeys]
    other = dict(idx=idx, tex_params=tparams, lens=lens,
                 frame_noise=np.moveaxis(np.asarray(noise), 1, 0))  # (2, W + 1, H, W)
    return (np.asarray(imgs), [np.asarray(x) for x in normals],
            {k: np.asarray(v) for k, v in other.items()})


@pytest.fixture(scope="module")
def fil_inputs(gt_dir):
    """(tiny config, bank slice of 2 windows, JAX params, JAX loss and
    gradients as a port state dict, JAX frames and normals)."""
    cfg = jfil.FilConfig(**CFG)
    bank = tfil.build_window_bank(4, tfil.FilConfig(**CFG), seed=3, gt_dir=gt_dir)
    bank_slice = {k: v[:2] for k, v in bank._asdict().items()}
    model = JaxUAHN(img_height=SIDE, img_width=SIDE, dropout_rate=0.0)
    img = jnp.zeros((SIDE, SIDE), jnp.float32)
    params = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                        img, img)["params"]
    c_rot_i, i_t_i2c = (jnp.asarray(x) for x in _camera())
    tex_bank = jnp.asarray(_tex_bank())
    tex_idx = jnp.arange(2)
    loss_fn = jfil.make_fil_loss(model, jax_make_params(T_ITOC, chi2_gate=100.0), cfg,
                                 JaxVioConfig(update_gate_frames=-1), c_rot_i, i_t_i2c,
                                 tex_bank, tex_idx)
    key = jax.random.PRNGKey(7)
    jb = {k: jnp.asarray(v) for k, v in bank_slice.items()}
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, jb, key)
    per_window = [_jax_draws(cfg, {k: v[b] for k, v in jb.items()}, k, tex_bank, tex_idx,
                             c_rot_i, i_t_i2c)
                  for b, k in enumerate(jax.random.split(key, cfg.batch_size))]
    ref = {n: g.numpy() for n, g in
           tckpt.params_from_numpy(jax.tree.map(np.asarray, grads)).items()}
    return bank_slice, jax.tree.map(np.asarray, params), float(loss), ref, per_window


def _port_loss(bank_slice, params, per_window, w_cons=0.0):
    """The port's batch loss on the JAX draws and frames, and its model."""
    cfg = tfil.FilConfig(**CFG, w_cons=w_cons)
    port = UAHN(dropout_rate=0.0, img_height=SIDE, img_width=SIDE)
    port.load_state_dict(tckpt.params_from_numpy(params))
    imgs = torch.as_tensor(np.stack([w[0] for w in per_window]))
    normals = [torch.as_tensor(np.stack([w[1][i] for w in per_window])) for i in range(9)]
    b = imgs.shape[0]
    zero = torch.zeros(b)
    draws = tfil.WindowDraws(zero.long(), torch.zeros(b, 5), torch.zeros(b, 6),
                             torch.zeros(2, *imgs.shape), *normals)
    win = {k: torch.as_tensor(v) for k, v in bank_slice.items()}
    losses = tfil.window_losses(port.flow_and_cov, make_params(T_ITOC, chi2_gate=100.0,
                                                               device="cpu"),
                                cfg, VioConfig(update_gate_frames=-1), win, imgs, draws)
    return tfil.mean_finite(losses), port


def test_window_loss_and_gradients_match_jax(fil_inputs):
    bank_slice, params, loss, ref, per_window = fil_inputs
    tloss, port = _port_loss(bank_slice, params, per_window)
    tloss.backward()
    assert np.isfinite(loss) and loss > 0
    np.testing.assert_allclose(tloss.item(), loss, rtol=LOSS_RTOL)
    grads = dict(port.named_parameters())
    assert ref.keys() == grads.keys()
    for name, want in ref.items():
        g = grads[name].grad
        if not np.abs(want).max() > 0:
            assert name.split(".")[0] in ("block1", "block2", "block3", "fc_block1",
                                          "fc_block2", "fc_block3"), name
            assert g is None or not g.any(), name
            continue
        got = g.numpy().ravel()
        want = want.ravel()
        cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
        assert cos >= GRAD_COS, (name, cos)
        assert abs(np.linalg.norm(got) / np.linalg.norm(want) - 1) <= GRAD_NORM_RTOL, name
    assert any(n.startswith("head_logvar") for n, w in ref.items() if np.abs(w).max() > 0)


def test_window_loss_with_the_consistency_term(fil_inputs):
    """``w_cons`` adds the NEES penalty: finite, larger, differentiable."""
    bank_slice, params, loss, _, per_window = fil_inputs
    plain, _ = _port_loss(bank_slice, params, per_window)
    tloss, port = _port_loss(bank_slice, params, per_window, w_cons=0.1)
    tloss.backward()
    assert torch.isfinite(tloss) and tloss.item() > plain.item()
    assert all(torch.isfinite(p.grad).all() for p in port.parameters() if p.grad is not None)


def test_mean_finite_skips_non_finite_windows():
    losses = torch.tensor([1.0, float("nan"), 3.0, float("inf")])
    assert tfil.mean_finite(losses).item() == 2.0
    assert tfil.mean_finite(torch.tensor([float("nan")])).item() == 0.0


def test_render_windows_is_one_sampler_call_per_batch(gt_dir, monkeypatch):
    """All windows' frames and taps in one flat-sampler call, frames at
    uint8 levels, each window on its own texture."""
    from cuahn_vio_torch.data import textures as tex_mod

    cfg = tfil.FilConfig(window=2, blur_taps=3, img_hw=(SIDE, SIDE))
    bank = tfil.build_window_bank(3, cfg, seed=1, gt_dir=gt_dir)
    win = {k: torch.as_tensor(v) for k, v in bank._asdict().items()}
    tex = torch.as_tensor(_tex_bank())
    draws = tfil.draw_windows(cfg, prng.split(prng.prng_key(0), 3), torch.arange(4), "cpu")
    calls = []
    sample = tex_mod.bilinear_sample

    def spy(texture, x, y):
        calls.append((tuple(texture.shape), tuple(x.shape)))
        return sample(texture, x, y)

    monkeypatch.setattr(tex_mod, "bilinear_sample", spy)
    c_rot_i, i_t_i2c = (torch.as_tensor(x) for x in _camera())
    imgs = tfil.render_windows(win, draws, cfg, c_rot_i, i_t_i2c, tex)
    assert calls == [((3, 128, 128), (3, 3 * 3 * SIDE * SIDE))]
    assert imgs.shape == (3, 3, SIDE, SIDE) and imgs.dtype == torch.uint8
    assert draws.frame_noise.shape == (2, 3, 3, SIDE, SIDE)


def test_step_schedule_and_windows_follow_the_jax_loop(monkeypatch):
    """The JAX ``fil_finetune`` loop, its batch, step and loss functions
    stubbed out, logs which steps are pair steps and (through the loss of
    a bank whose window n holds n) which windows each FIL step takes; the
    port's ``step_kinds`` gives the same, and the pair steps' coins."""
    from cuahn_vio.ops import warp as jwarp
    from cuahn_vio.train import trainer as jtrain

    n_win, batch, steps, every, seed = 8, 2, 9, 3, 5
    ids = np.arange(n_win, dtype=np.float32)
    shape = lambda *s: np.zeros((n_win, *s), np.float32)  # noqa: E731
    bank = jfil.WindowBank(tap_p=shape(2, 1, 3), tap_q=shape(2, 1, 4), w_true=shape(1, 1, 3),
                           a_true=shape(1, 1, 3), dt=ids[:, None, None] + shape(1, 1),
                           gt_p=shape(2, 3), gt_q=shape(2, 4), gt_v=shape(2, 3))
    coins = []

    def fake_loss(*args, **kwargs):
        def loss_fn(params, bank_slice, key):
            return bank_slice["dt"][0, 0, 0] * n_win + bank_slice["dt"][1, 0, 0] + 0.0 * jnp.sum(
                params["w"])
        return loss_fn

    def fake_step(model, cfg, tx):
        def step(params, opt_state, batch_, key, use_prior):
            coins.append(use_prior)
            return params, opt_state, -1.0, None
        return step

    monkeypatch.setattr(jwarp, "WARP_IMPL", jwarp.WARP_IMPL)  # restored after the run
    monkeypatch.setattr(jfil, "make_fil_loss", fake_loss)
    monkeypatch.setattr(jtrain, "make_train_step", fake_step)
    monkeypatch.setattr(jtrain, "make_batch", lambda *a, **k: None)
    monkeypatch.setattr(jtex, "get_texture_bank", lambda *a, **k: np.zeros((4, 8, 8)))
    log = []
    jfil.fil_finetune(None, {"w": jnp.zeros(3)}, None, None, None,
                      jfil.FilConfig(batch_size=batch), steps=steps, seed=seed, bank=bank,
                      log_every=1, log_fn=lambda m, **_: log.append(m), pair_step_every=every)
    logged = [m for m in log if m.startswith("step")]
    kinds = tfil.step_kinds(steps, every, n_win, batch, seed)
    assert [k for k, _ in kinds] == [m.split("[")[1].split("]")[0] for m in logged]
    fil_windows = [round(float(m.split("loss ")[1])) for m in logged if "[fil]" in m]
    assert fil_windows == [int(a[0]) * n_win + int(a[1]) for k, a in kinds if k == "fil"]
    assert coins == [a for k, a in kinds if k == "pair"] and len(coins) == steps // every
    assert [k for k, _ in tfil.step_kinds(4, 0, n_win, batch, seed)] == ["fil"] * 4


def test_fil_finetune_runs_and_checkpoints(gt_dir, tmp_path, monkeypatch):
    """Three FIL steps at the tiny config on the CPU give finite losses,
    move block 4 and write a checkpoint the port reads back; a pair step
    needs 224x320, so the interleave is off here."""
    cfg = tfil.FilConfig(**CFG)
    model = UAHN(img_height=SIDE, img_width=SIDE)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    c_rot_i, i_t_i2c = (torch.as_tensor(x) for x in _camera())
    log = []
    bank = tfil.build_window_bank(4, cfg, seed=0, gt_dir=gt_dir)
    out = str(tmp_path / "w.msgpack")
    monkeypatch.setattr(tfil, "texture_bank_u8",
                        lambda dev: torch.as_tensor(_tex_bank(), device=dev))
    tfil.fil_finetune(model, make_params(T_ITOC, device="cpu"), c_rot_i, i_t_i2c, cfg,
                      steps=3, lr=1e-3, bank=bank, log_every=1,
                      log_fn=lambda m, **_: log.append(m), checkpoint_path=out,
                      save_every=1, pair_step_every=0)
    losses = [float(m.split("loss ")[1]) for m in log if m.startswith("step")]
    assert len(losses) == 3 and np.isfinite(losses).all()
    moved = [k for k, v in model.state_dict().items() if not torch.equal(v, before[k])]
    assert any(k.startswith("block4") for k in moved)
    assert tckpt.load_params(out).keys() == before.keys()


def test_cli_train_fil_refuses_without_gt_files(tmp_path, monkeypatch):
    from cuahn_vio_torch.data import trajpairs

    monkeypatch.setattr(trajpairs, "GT_DIR", str(tmp_path))
    with pytest.raises(SystemExit, match=f"no training trajectory in {tmp_path}.*_with_gt.txt"):
        tcli.main(["train-fil", "--resume", "w.msgpack", "--device", "cpu"])


def test_cli_train_fil_exits_non_zero_naming_the_directory():
    proc = subprocess.run(
        [sys.executable, "-m", "cuahn_vio_torch.cli", "train-fil", "--resume",
         os.path.join(REPO, "weights", "uahn_fil_v10.msgpack"), "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=300)
    from cuahn_vio_torch.data.trajpairs import GT_DIR

    assert proc.returncode != 0
    assert GT_DIR in proc.stderr and "*_with_gt.txt" in proc.stderr
