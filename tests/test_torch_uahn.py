"""The port's UAHN against the flax model, shipped v10 weights, 224x320.

Both run float32 on the CPU with dropout_rate = 0 (the parity at the
shipped p = 0.05, with the JAX package's masks drawn from one key, is
``tests/test_torch_dropout_parity.py``'s).
Tolerances: flow8 5e-4 px absolute; cov88 1e-4 relative plus 1e-4 px²
absolute (measured agreement is ~6e-5 px and ~2e-5 relative; the towers
sum thousands of products in another order, and the JAX model warps with
``homography_warp_mm``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuahn_vio.models.uahn import UAHN as JaxUAHN
from cuahn_vio_torch.models.uahn import MC_DROPOUT_NUM, build_uahn
from cuahn_vio_torch.utils import prng
from cuahn_vio_torch.utils.checkpoint import load_params, params_from_numpy

# the suite runs in several worker processes: keep torch to a few threads
torch.set_num_threads(2)

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "weights", "uahn_fil_v10.msgpack")
FLOW_ATOL = 5e-4
COV_ATOL = 1e-4
COV_RTOL = 1e-4


@pytest.fixture(scope="module")
def jax_params():
    """The flax tree as the JAX package reads it (``msgpack_restore`` is
    what ``load_params`` checks against its template)."""
    from flax import serialization

    with open(WEIGHTS, "rb") as f:
        return serialization.msgpack_restore(f.read())


@pytest.fixture(scope="module")
def torch_model():
    return build_uahn(load_params(WEIGHTS), device="cpu", dropout_rate=0.0)


@pytest.fixture(scope="module")
def frames():
    """A textured pair related by a small shift, plus a prior offset."""
    rng = np.random.default_rng(30)
    base = rng.integers(0, 256, (232, 330)).astype(np.uint8)
    img1 = base[4:228, 5:325].copy()
    img2 = base[2:226, 2:322].copy()
    prior = rng.normal(0, 2.0, (4, 2)).astype(np.float32)
    return img1, img2, prior


def _jax_forward(params, img1, img2, prior, use_prior, blocks_to_run=3):
    model = JaxUAHN(dropout_rate=0.0, blocks_to_run=blocks_to_run)
    f, c = model.apply(
        {"params": params},
        jnp.array(img1, jnp.float32) / 255.0,
        jnp.array(img2, jnp.float32) / 255.0,
        jnp.array(prior) if use_prior else None,
        use_prior=use_prior,
        rngs={"dropout": jax.random.PRNGKey(1)},
    )
    return np.asarray(f), np.asarray(c)


@pytest.mark.parametrize("use_prior", [True, False])
def test_uahn_matches_flax_v10(jax_params, torch_model, frames, use_prior):
    img1, img2, prior = frames
    ref_f, ref_c = _jax_forward(jax_params, img1, img2, prior, use_prior)
    f, c = torch_model(
        torch.from_numpy(img1)[None], torch.from_numpy(img2)[None],
        torch.from_numpy(prior)[None], use_prior=use_prior,
    )
    assert f.shape == (1, 8) and c.shape == (1, 8, 8)
    np.testing.assert_allclose(f[0].numpy(), ref_f, atol=FLOW_ATOL, rtol=0)
    np.testing.assert_allclose(c[0].numpy(), ref_c, atol=COV_ATOL, rtol=COV_RTOL)


@pytest.mark.parametrize("blocks_to_run", [1, 2])
def test_uahn_prior_cascade_depths_match_flax(jax_params, frames, blocks_to_run):
    img1, img2, prior = frames
    ref_f, ref_c = _jax_forward(jax_params, img1, img2, prior, True, blocks_to_run)
    model = build_uahn(load_params(WEIGHTS), device="cpu", dropout_rate=0.0,
                       blocks_to_run=blocks_to_run)
    f, c = model(torch.from_numpy(img1)[None], torch.from_numpy(img2)[None],
                 torch.from_numpy(prior)[None], use_prior=True)
    np.testing.assert_allclose(f[0].numpy(), ref_f, atol=FLOW_ATOL, rtol=0)
    np.testing.assert_allclose(c[0].numpy(), ref_c, atol=COV_ATOL, rtol=COV_RTOL)


def test_uint8_and_float_frames_give_the_same_flow(torch_model, frames):
    img1, img2, prior = frames
    args = (torch.from_numpy(prior)[None],)
    f_u8, _ = torch_model(torch.from_numpy(img1)[None], torch.from_numpy(img2)[None],
                          *args, use_prior=True)
    f_f, _ = torch_model(torch.from_numpy(img1 / np.float32(255))[None].float(),
                         torch.from_numpy(img2 / np.float32(255))[None].float(),
                         *args, use_prior=True)
    np.testing.assert_allclose(f_u8.numpy(), f_f.numpy(), atol=1e-4, rtol=0)


def test_batched_forward_equals_per_example(torch_model, frames):
    img1, img2, prior = frames
    i1 = torch.from_numpy(np.stack([img1, img2]))
    i2 = torch.from_numpy(np.stack([img2, img1]))
    pr = torch.from_numpy(np.stack([prior, -prior]))
    fb, cb = torch_model(i1, i2, pr, use_prior=True)
    for k in range(2):
        f, c = torch_model(i1[k:k + 1], i2[k:k + 1], pr[k:k + 1], use_prior=True)
        np.testing.assert_allclose(fb[k].numpy(), f[0].numpy(), atol=1e-4, rtol=0)
        np.testing.assert_allclose(cb[k].numpy(), c[0].numpy(), atol=1e-5, rtol=0)


def test_mc_dropout_members_are_seeded_and_distinct(frames):
    """With dropout on, the 16 members differ, the same key reproduces
    them (a call key, or its four mask keys), another key gives others,
    and the keep rate is the configured 0.95."""
    img1, img2, prior = frames
    model = build_uahn(load_params(WEIGHTS), device="cpu", dropout_rate=0.05)
    i1, i2 = torch.from_numpy(img1)[None], torch.from_numpy(img2)[None]
    with torch.no_grad():
        h = model.cascade_flows(i1, i2, torch.from_numpy(prior)[None], use_prior=True)[1]

    def members(keys):
        with torch.no_grad():
            return model.last_block_members(i1, i2, h, keys)

    m1, lv1 = members(prng.prng_key(5)[None])
    m2, _ = members(prng.keys_tensor(prng.mask_keys(prng.prng_key(5)[None])))
    m3, _ = members(prng.prng_key(6)[None])
    assert m1.shape == (1, MC_DROPOUT_NUM, 4, 2) and lv1.shape == m1.shape
    assert torch.equal(m1, m2) and not torch.equal(m1, m3)
    assert (m1[0].std(dim=0) > 0).all()
    with pytest.raises(ValueError, match="dropout_keys"):
        members(None)
    x = torch.ones(200_000)
    from cuahn_vio_torch.models.uahn import _dropout

    mask = prng.bernoulli(prng.keys_tensor(prng.prng_key(0)[None]), (200_000,), 0.95)[0]
    kept = (_dropout(x, 0.05, mask.bool()) > 0).float().mean()
    assert abs(kept.item() - 0.95) < 3e-3


def test_params_from_numpy_loads_flax_tree(jax_params):
    """The state dict built from the flax tree in memory equals the one read
    from the file, and fills every parameter of the module."""
    tree = jax.tree.map(np.asarray, jax_params)
    sd = params_from_numpy(tree)
    model = build_uahn(sd, device="cpu")
    assert set(sd) == set(model.state_dict())
    file_sd = load_params(WEIGHTS)
    for k, v in sd.items():
        assert torch.equal(v, file_sd[k]), k
