"""The port's random UAHN (``models/uahn.init_uahn``) against the JAX
``init_uahn`` on the CPU, and the verbs that start from it.

- ``init_uahn(PRNGKey(s))`` against the JAX ``init_uahn(PRNGKey(s))
  ["params"]``, leaf for leaf, at the JAX tests' 56x80 for two seeds and
  at the shipped 224x320: every bias 0 in both; every kernel equal bit for
  bit but where XLA's CPU ``erf_inv`` (its ``log1p``) rounds otherwise
  than the port's: there within the unit truncated normal's 2.4e-7 times
  the leaf's scale, plus one rounding of the scaled value, on under 1 % of
  the values (measured: 0.88-0.90 %, at most 4 ulp of the value);
- the weightless verbs: ``run-vio`` / ``run-vio-batch``'s model
  (``cli._model`` without weights) is ``init_uahn(PRNGKey(0))`` at the
  config's blocks and dropout, the trainers' (``cli._initial_uahn``)
  ``init_uahn(PRNGKey(seed))`` without ``--resume`` and the resumed
  weights with it (``tests/test_torch_weightless_cli.py`` runs the verbs).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from cuahn_vio.models.uahn import init_uahn as jax_init_uahn
from cuahn_vio_torch import cli as tcli
from cuahn_vio_torch.models.uahn import TRUNC_NORMAL_STD, init_uahn
from cuahn_vio_torch.utils import checkpoint as tckpt
from cuahn_vio_torch.utils import prng
from cuahn_vio_torch.utils.config import VioOptions
from tests.test_torch_run_vio_flags import WEIGHTS

# the suite runs in several worker processes: keep torch to a few threads
torch.set_num_threads(2)

UNIT_TOL = 2.4e-7  # a unit truncated normal's draws against jax.random's
UNEQUAL_SHARE = 0.01  # of the kernels' values that may differ


@functools.lru_cache(maxsize=None)
def _port_state(seed: int, height: int, width: int) -> dict:
    return init_uahn(prng.prng_key(seed), height, width, device="cpu").state_dict()


def _jax_state(seed: int, height: int, width: int) -> dict:
    _, params = jax_init_uahn(jax.random.PRNGKey(seed), img_height=height, img_width=width)
    return tckpt.params_from_numpy(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("seed, height, width", [(0, 56, 80), (5, 56, 80), (0, 224, 320)],
                         ids=["56x80-seed0", "56x80-seed5", "224x320-seed0"])
def test_init_uahn_matches_jax(seed, height, width):
    want = _jax_state(seed, height, width)
    got = _port_state(seed, height, width)
    assert got.keys() == want.keys()
    values = unequal = 0
    for name, ref in want.items():
        out = got[name]
        assert out.shape == ref.shape and out.dtype == torch.float32, name
        if name.endswith(".bias"):
            assert not out.any() and not ref.any(), name
            continue
        std = np.sqrt(np.float32(1.0 / out[0].numel())) / np.float32(TRUNC_NORMAL_STD)
        a, b = out.numpy(), ref.numpy()
        diff = np.abs(a - b)
        assert (diff <= UNIT_TOL * std + np.spacing(np.abs(b))).all(), name
        assert np.abs(b).max() < 2 * std and b.std() > 0.7 * std, name  # truncated LeCun
        values += a.size
        unequal += int((diff > 0).sum())
    assert unequal / values < UNEQUAL_SHARE, unequal / values


def test_weightless_verbs_start_from_init_uahn():
    """``run-vio``'s model without weights is ``init_uahn(PRNGKey(0))`` at
    the config's blocks and dropout, and so is the trainers' at seed 0
    without ``--resume``; with weights, both are the weights."""
    opts = VioOptions()
    opts.blocks_to_run, opts.mc_dropout = 2, 0.1
    model = tcli._model(opts, None, "cpu")
    want = _port_state(0, 224, 320)
    assert (model.blocks_to_run, model.dropout_rate) == (2, 0.1)
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())
    trainer = tcli._initial_uahn(0, None, "cpu").state_dict()
    assert all(torch.equal(trainer[k], want[k]) for k in want)
    seed5 = _port_state(5, 56, 80)  # the seeds draw other weights
    assert not torch.equal(seed5["block4.conv0.weight"], _port_state(0, 56, 80)[
        "block4.conv0.weight"])
    shipped = tckpt.load_params(WEIGHTS)
    for built in (tcli._model(opts, WEIGHTS, "cpu"), tcli._initial_uahn(3, WEIGHTS, "cpu")):
        state = built.state_dict()
        assert all(torch.equal(state[k], shipped[k]) for k in shipped)
