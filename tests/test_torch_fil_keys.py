"""The FIL window draws from the JAX key chain (``train/fil.draw_windows``)
and the window loss of a step key alone (``make_fil_loss``), against the
JAX ``window_loss`` on the CPU, at ``tests/test_torch_fil.py``'s tiny
config (window 2, batch 2, 4 IMU intervals, one blur tap, 64x64 frames,
a 64x64 UAHN with the same random weights, MC dropout off).

The JAX draws are recomputed from the JAX loss's key splits
(``tests/test_torch_fil._jax_draws``: ``split(step key, B)``, each
window's ``split(k, 10)`` and the frames' ``split(., W + 1)``).

Tolerances:
- the texture picks equal; the transforms and lenses within 1e-6 relative
  + 1e-7 (exp, cos, sin and the offset's normal in float32); every normal
  (the frames' read and shot noise, the biases, the IMU white noise, the
  initial errors) within NORMAL_ATOL (``tests/test_torch_prng.py``'s
  bound: XLA's CPU ``log1p``);
- the batch loss of the key alone (the port's draws, its own render of the
  frames, its filter) within ``tests/test_torch_fil.py``'s LOSS_RTOL of
  the JAX loss at that key (measured 7.7e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuahn_vio.filter import make_params as jax_make_params
from cuahn_vio.models.uahn import UAHN as JaxUAHN
from cuahn_vio.pipeline.vio import VioConfig as JaxVioConfig
from cuahn_vio.train import fil as jfil
from cuahn_vio_torch.filter.state import make_params
from cuahn_vio_torch.models.uahn import UAHN
from cuahn_vio_torch.pipeline.vio import VioConfig
from cuahn_vio_torch.train import fil as tfil
from cuahn_vio_torch.utils import checkpoint as tckpt
from cuahn_vio_torch.utils import prng
from tests.test_propagate import T_ITOC
from tests.test_torch_fil import LOSS_RTOL, SIDE, _camera, _jax_draws, _tex_bank
from tests.test_torch_fil_bank import CFG, gt_dir  # noqa: F401 (a fixture)

# the suite runs in several worker processes: keep torch to a few threads
torch.set_num_threads(2)

NORMAL_ATOL = 1e-6
STEP_KEY = 11  # PRNGKey of the FIL step


@pytest.fixture(scope="module")
def jax_step(gt_dir):  # noqa: F811
    """(bank slice of 2 windows, JAX params, the JAX loss at the step key,
    the JAX draws of each window)."""
    cfg = jfil.FilConfig(**CFG)
    bank = tfil.build_window_bank(4, tfil.FilConfig(**CFG), seed=3, gt_dir=gt_dir)
    bank_slice = {k: v[:2] for k, v in bank._asdict().items()}
    model = JaxUAHN(img_height=SIDE, img_width=SIDE, dropout_rate=0.0)
    img = jnp.zeros((SIDE, SIDE), jnp.float32)
    params = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                        img, img)["params"]
    c_rot_i, i_t_i2c = (jnp.asarray(x) for x in _camera())
    tex_bank, tex_idx = jnp.asarray(_tex_bank()), jnp.arange(3)
    loss_fn = jfil.make_fil_loss(model, jax_make_params(T_ITOC, chi2_gate=100.0), cfg,
                                 JaxVioConfig(update_gate_frames=-1), c_rot_i, i_t_i2c,
                                 tex_bank, tex_idx)
    key = jax.random.PRNGKey(STEP_KEY)
    jb = {k: jnp.asarray(v) for k, v in bank_slice.items()}
    loss = float(jax.jit(loss_fn)(params, jb, key))
    per_window = [_jax_draws(cfg, {k: v[b] for k, v in jb.items()}, k, tex_bank, tex_idx,
                             c_rot_i, i_t_i2c)
                  for b, k in enumerate(jax.random.split(key, cfg.batch_size))]
    return bank_slice, jax.tree.map(np.asarray, params), loss, per_window


def test_draw_windows_are_the_jax_window_losss_draws(jax_step):
    _, _, _, per_window = jax_step
    cfg = tfil.FilConfig(**CFG)
    draws = tfil.draw_windows(cfg, prng.split(prng.prng_key(STEP_KEY), cfg.batch_size),
                              torch.arange(3), "cpu")
    other = [w[2] for w in per_window]
    np.testing.assert_array_equal(draws.tex_idx.numpy(), [o["idx"] for o in other])
    for name in ("tex_params", "lens"):
        np.testing.assert_allclose(getattr(draws, name).numpy(), [o[name] for o in other],
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(draws.frame_noise.numpy(),
                               np.stack([o["frame_noise"] for o in other], axis=1),
                               atol=NORMAL_ATOL, rtol=0)
    for i, name in enumerate(tfil.WindowDraws._fields[4:]):
        np.testing.assert_allclose(getattr(draws, name).numpy(),
                                   np.stack([w[1][i] for w in per_window]),
                                   atol=NORMAL_ATOL, rtol=0, err_msg=name)


def test_window_loss_of_the_step_key_matches_jax(jax_step):
    bank_slice, params, loss, _ = jax_step
    cfg = tfil.FilConfig(**CFG)
    port = UAHN(dropout_rate=0.0, img_height=SIDE, img_width=SIDE)
    port.load_state_dict(tckpt.params_from_numpy(params))
    c_rot_i, i_t_i2c = (torch.as_tensor(x) for x in _camera())
    loss_fn = tfil.make_fil_loss(port, make_params(T_ITOC, chi2_gate=100.0, device="cpu"), cfg,
                                 VioConfig(update_gate_frames=-1), c_rot_i, i_t_i2c,
                                 torch.as_tensor(_tex_bank()), torch.arange(3))
    got = loss_fn({k: torch.as_tensor(v) for k, v in bank_slice.items()},
                  prng.prng_key(STEP_KEY))
    assert np.isfinite(loss) and loss > 0
    np.testing.assert_allclose(got.item(), loss, rtol=LOSS_RTOL)
