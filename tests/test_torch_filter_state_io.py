"""``save_filter_state`` / ``load_filter_state`` of the port against the
JAX package's (``cuahn_vio/utils/checkpoint.py``): a state written by
either loads in the other with the same arrays, bit for bit, with the
optional bias block and without it (its fields then absent from the npz
and None after loading)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuahn_vio.filter.state import FilterState as JaxFilterState
from cuahn_vio.utils import checkpoint as jckpt
from cuahn_vio_torch.filter.state import FilterState
from cuahn_vio_torch.utils import checkpoint as tckpt

SHAPES = dict(p=(3,), q=(4,), v=(3,), ba=(3,), bg=(3,), off=(4, 3), cov=(27, 27),
              bias=(8,), cov_xb=(27, 8), cov_bb=(8, 8))
BIAS_FIELDS = ("bias", "cov_xb", "cov_bb")


def _arrays(with_bias: bool) -> dict:
    rng = np.random.default_rng(4)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()
            if with_bias or k not in BIAS_FIELDS}


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
def test_jax_state_loads_in_the_port(tmp_path, with_bias):
    arrays = _arrays(with_bias)
    path = str(tmp_path / "jax_state.npz")
    jckpt.save_filter_state(path, JaxFilterState(**{k: jnp.asarray(v) for k, v in arrays.items()}))
    state = tckpt.load_filter_state(path, device="cpu")
    assert isinstance(state, FilterState)
    for k in SHAPES:
        got = getattr(state, k)
        if k in arrays:
            assert got.device.type == "cpu" and got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), arrays[k])
        else:
            assert got is None


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
def test_port_state_loads_in_jax(tmp_path, with_bias):
    arrays = _arrays(with_bias)
    path = str(tmp_path / "port_state.npz")
    tckpt.save_filter_state(path, FilterState(**{k: torch.as_tensor(v)
                                                 for k, v in arrays.items()}))
    with np.load(path) as d:
        assert sorted(d.files) == sorted(arrays)  # a None field is left out
    state = jckpt.load_filter_state(path)
    for k in SHAPES:
        got = getattr(state, k)
        if k in arrays:
            np.testing.assert_array_equal(np.asarray(got), arrays[k])
        else:
            assert got is None
