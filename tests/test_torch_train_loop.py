"""Two steps of the port's ``train`` against two steps of the JAX
``train`` on the CPU: the same seed, the same initial weights (each
package's ``init_uahn(PRNGKey(seed))``), 56x80, batch 2 (which the JAX
tests' 8 devices do not divide: no mesh), photo textures and effects on a
bank of four procedural textures both packages read, MC dropout at 0.05
(the masks of the same keys), no probe.

Both trainers draw the same pairs from the same keys (``make_batch(kb)``,
``tests/test_torch_train_keys.py``), flip the same prior-mode coins and
take the same masks, so their logged lines agree: the same modes and skip
counts, the loss and its three parts within LOSS_RTOL relative (the logs
print 4 decimals; measured: every printed value equal but one, 0.7916
against 0.7915, 1.3e-4 relative).
"""

import jax
import numpy as np
import torch

from cuahn_vio.models.uahn import init_uahn as jax_init_uahn
from cuahn_vio.ops import warp as jwarp
from cuahn_vio.train import trainer as jtrain
from cuahn_vio_torch.data import textures as ttex
from cuahn_vio_torch.models.uahn import init_uahn
from cuahn_vio_torch.train import trainer as ttrain
from cuahn_vio_torch.utils import prng
from cuahn_vio_torch.utils.config import VioOptions

# the suite runs in several worker processes: keep torch to a few threads
torch.set_num_threads(2)

H, W = 56, 80
SEED = 2  # its host stream flips prior mode on both steps: one JAX step compiled
LOSS_RTOL = 1e-3


def _camera():
    t = np.asarray(VioOptions.uzhfpv_indoor45().t_imu_to_cam, np.float64)
    return (t[:3, :3].astype(np.float32),
            (-t[:3, :3].T @ t[:3, 3]).astype(np.float32))


def _logged(lines):
    """(losses (n, 4): loss, cascade, mean, nll; modes; skip counts)."""
    steps = [line.split() for line in lines if line.startswith("step")]
    losses = np.array([[float(s[s.index(k) + 1]) for k in ("loss", "cascade", "mean", "nll")]
                       for s in steps])
    return losses, [s[-2] for s in steps], [s[-1] for s in steps]


def test_two_train_steps_log_the_jax_trainers_losses(monkeypatch, tmp_path):
    from cuahn_vio.data import textures as jtex

    levels = ttex.quantize_u8(np.stack(ttex._procedural_extras(128)[:4]))
    monkeypatch.setattr(jtex, "get_texture_bank", lambda *a, **k: levels)
    monkeypatch.setattr(ttrain, "texture_bank_u8", lambda dev: torch.as_tensor(
        np.stack([ttex.texture_u8(t) for t in levels]), device=dev))
    monkeypatch.setattr(jwarp, "WARP_IMPL", jwarp.WARP_IMPL)  # the JAX train sets it
    kw = dict(batch_size=2, blur_taps=2, traj_pair_prob=0.0)
    c_rot_i, i_t_i2c = _camera()

    jax_log = []
    model, params = jax_init_uahn(jax.random.PRNGKey(SEED), img_height=H, img_width=W)
    jtrain.train(model, params, c_rot_i, i_t_i2c, jtrain.TrainConfig(**kw), steps=2,
                 seed=SEED, log_every=1, height=H, width=W, probe_every=0,
                 log_fn=lambda m, **_: jax_log.append(m))
    port_log = []
    port = init_uahn(prng.prng_key(SEED), H, W, device="cpu")
    ttrain.train(port, torch.as_tensor(c_rot_i), torch.as_tensor(i_t_i2c),
                 ttrain.TrainConfig(**kw), steps=2, seed=SEED, log_every=1, height=H, width=W,
                 probe_every=0, log_fn=lambda m, **_: port_log.append(m),
                 gt_dir=str(tmp_path / "no_gt"))
    want, want_modes, want_skips = _logged(jax_log)
    got, modes, skips = _logged(port_log)
    assert want.shape == (2, 4) and np.isfinite(want).all()
    assert modes == want_modes == ["prior=True"] * 2 and skips == want_skips
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert not np.array_equal(want[0], want[1])  # the second step trained on new pairs
