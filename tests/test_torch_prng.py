"""The port's JAX random stream (``utils/prng``) against ``jax.random`` and
Flax on the CPU, and ``make-synthetic``'s key-drawn data against the JAX
``make_sequence``.

- keys, ``split``, ``fold_in``, bits, uniform and bernoulli: equal to
  ``jax.random``'s bit for bit (``jax_threefry_partitionable``, JAX's
  default);
- randint: equal bit for bit;
- normal and truncated normal (at the initializers' (-2, 2)): within 1e-6
  absolute, signs equal (XLA's CPU ``log1p`` is its own polynomial, so ~1 %
  of values differ in the last bits);
- Flax's rng folding: a live ``nn.Dropout`` mask and the four masks of the
  JAX ``UAHN``'s heads under ``rngs={"dropout": key}``, captured by
  wrapping ``jax.random.bernoulli`` where Flax calls it;
- ``make_sequence``'s procedural ground and ``--effects`` frames at one
  seed, texture seed and effects seed: uint8 frames at most one level
  apart, on at most 0.1 % of the pixels (measured: 3e-5 and 6e-5, the
  ground's sinusoids summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuahn_vio.data.sensor_effects import EffectsConfig as JaxEffectsConfig
from cuahn_vio.data.synthetic import AnalyticTrajectory as JaxTraj
from cuahn_vio.data.synthetic import make_sequence as jax_make_sequence
from cuahn_vio.models.uahn import UAHN as JaxUAHN
from cuahn_vio_torch.data.sensor_effects import EffectsConfig, draw_params
from cuahn_vio_torch.data.synthetic import AnalyticTrajectory, make_sequence
from cuahn_vio_torch.ops import cuda as tcuda
from cuahn_vio_torch.utils import prng
from cuahn_vio_torch.utils.config import VioOptions

# the suite runs in several worker processes: keep torch to a few threads
torch.set_num_threads(2)

NORMAL_ATOL = 1e-6
FRAME_SHARE = 1e-3  # of pixels that may be one uint8 level apart
SHAPES = [(7,), (8,), (16, 5120), (3, 224, 320)]
SHAPE_IDS = ["odd", "even", "mask", "frames"]


def _data(key) -> np.ndarray:
    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        key = jax.random.key_data(key)
    return np.asarray(key)


def _keys(n: int = 3) -> np.ndarray:
    return np.stack([prng.fold_in(prng.prng_key(42), i) for i in range(n)])


@pytest.mark.parametrize("seed", [0, 7, 2**33 + 5])
def test_prng_key_matches_jax(seed):
    assert prng.prng_key(seed).dtype == np.uint32
    np.testing.assert_array_equal(prng.prng_key(seed), _data(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("n", [1, 6, 1000])
def test_split_matches_jax(n):
    key = prng.prng_key(42)
    np.testing.assert_array_equal(prng.split(key, n), _data(jax.random.split(jnp.asarray(key), n)))
    # of many keys at once: each key's own split
    many = prng.split(_keys(), n)
    for k, row in zip(_keys(), many):
        np.testing.assert_array_equal(row, prng.split(k, n))


@pytest.mark.parametrize("data", [0, 1, 10_000, 2**32 - 1])
def test_fold_in_matches_jax(data):
    key = prng.prng_key(42)
    np.testing.assert_array_equal(prng.fold_in(key, data),
                                  _data(jax.random.fold_in(jnp.asarray(key), data)))
    # an array of data, and an array of keys
    np.testing.assert_array_equal(prng.fold_in(key, np.array([data, 3]))[0],
                                  prng.fold_in(key, data))
    np.testing.assert_array_equal(prng.fold_in(_keys(), data)[2], prng.fold_in(_keys()[2], data))


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_bits_uniform_bernoulli_match_jax_bit_for_bit(shape):
    keys = _keys()
    kt = prng.keys_tensor(keys)
    before = dict(tcuda.launch_counts)
    bits = prng.random_bits(kt, shape)
    uni = prng.uniform(kt, shape)
    ranged = prng.uniform(kt, shape, 0.3, 1.7)
    ber = prng.bernoulli(kt, shape, 0.95)
    assert tcuda.launch_counts == before  # CPU keys take the plain version
    assert bits.shape == (3, *shape) and ber.dtype == torch.uint8
    for i, key in enumerate(keys):
        k = jnp.asarray(key)
        np.testing.assert_array_equal(bits[i].numpy().view(np.uint32),
                                      np.asarray(jax.random.bits(k, shape, jnp.uint32)))
        np.testing.assert_array_equal(uni[i].numpy().view(np.uint32),
                                      np.asarray(jax.random.uniform(k, shape)).view(np.uint32))
        want = np.asarray(jax.random.uniform(k, shape, minval=0.3, maxval=1.7))
        np.testing.assert_array_equal(ranged[i].numpy().view(np.uint32), want.view(np.uint32))
        np.testing.assert_array_equal(ber[i].numpy().astype(bool),
                                      np.asarray(jax.random.bernoulli(k, 0.95, shape)))


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_normal_matches_jax(shape):
    keys = _keys()
    nor = prng.normal(prng.keys_tensor(keys), shape)
    for i, key in enumerate(keys):
        want = np.asarray(jax.random.normal(jnp.asarray(key), shape))
        got = nor[i].numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=NORMAL_ATOL, rtol=0)
        np.testing.assert_array_equal(np.sign(got), np.sign(want))


@pytest.mark.parametrize("lo, hi", [(0, 10), (0, 16), (-7, 100_000), (3, 3), (5, 2),
                                    (-2**31, 2**31 - 1)],
                         ids=["span10", "span16", "span100007", "empty", "reversed", "int32"])
def test_randint_matches_jax(lo, hi):
    """``jax.random.randint`` for int32, bit for bit: spans that are and
    are not powers of 2, hi <= lo (lo every time), the widest span; shapes
    () and (4,), keys with leading dims."""
    keys = _keys(5)
    for shape in ((), (4,)):
        got = prng.randint(keys, shape, lo, hi)
        assert got.dtype == torch.int32 and got.shape == (5, *shape)
        want = np.stack([np.asarray(jax.random.randint(jnp.asarray(k), shape, lo, hi))
                         for k in keys])
        np.testing.assert_array_equal(got.numpy(), want)
    nested = prng.randint(keys[:4].reshape(2, 2, 2), (3,), lo, hi)
    assert nested.shape == (2, 2, 3)
    np.testing.assert_array_equal(nested.reshape(4, 3).numpy(),
                                  prng.randint(keys[:4], (3,), lo, hi).numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_truncated_normal_matches_jax(shape):
    """``jax.random.truncated_normal(key, -2, 2, shape)`` (the initializers'
    bounds): within NORMAL_ATOL, signs equal, every value inside (-2, 2)."""
    keys = _keys()
    got = prng.truncated_normal(prng.keys_tensor(keys), shape, -2.0, 2.0)
    assert got.dtype == torch.float32 and got.shape == (3, *shape)
    assert float(got.abs().max()) < 2.0
    for i, key in enumerate(keys):
        want = np.asarray(jax.random.truncated_normal(jnp.asarray(key), -2, 2, shape))
        np.testing.assert_allclose(got[i].numpy(), want, atol=NORMAL_ATOL, rtol=0)
        np.testing.assert_array_equal(np.sign(got[i].numpy()), np.sign(want))


def test_draw_fields_is_each_fields_own_draw():
    """Fields of one mode in one draw (host keys of any leading shape, each
    its own value shape) equal each field drawn alone."""
    a, b = prng.split(prng.prng_key(1), 6).reshape(2, 3, 2), prng.split(prng.prng_key(2), 4)
    before = dict(tcuda.launch_counts)
    x, y = prng.draw_fields([(a, (5,)), (b, (2, 3))], prng.UNIFORM, "cpu", 0.5, 4.0)
    assert tcuda.launch_counts == before
    assert x.shape == (2, 3, 5) and y.shape == (4, 2, 3)
    assert torch.equal(x.reshape(6, 5), prng.uniform(prng.keys_tensor(a.reshape(6, 2)), (5,),
                                                     0.5, 4.0))
    assert torch.equal(y, prng.draw_field(b, (2, 3), prng.UNIFORM, "cpu", 0.5, 4.0))


def test_rows_of_mixed_counts_are_each_keys_own_draw():
    """One draw of K keys with their own counts (the kernel's layout: rows
    back to back) equals each key drawn alone."""
    keys = _keys(4)
    kt = prng.keys_tensor(keys)
    counts = [5, 0, 16 * 256, 3]
    flat = prng.draw(kt, counts, prng.NORMAL)
    rows = torch.split(flat, counts)
    for i, c in enumerate(counts):
        assert torch.equal(rows[i], prng.normal(kt[i:i + 1], (c,))[0])
    listed = prng.uniform(kt, [(5,), (0,), (16, 256), (3,)], 0.0, 2.0)
    assert [tuple(r.shape) for r in listed] == [(5,), (0,), (16, 256), (3,)]
    with pytest.raises(ValueError, match="counts"):
        prng.draw(kt, counts[:3], prng.BITS)
    with pytest.raises(ValueError, match="int32"):
        prng.draw(kt.to(torch.int64), counts, prng.BITS)


def test_flax_fold_matches_a_live_dropout_mask():
    """``nn.Dropout(0.05)`` under ``rngs={"dropout": k}`` at the top of a
    module named "head": its mask is bernoulli of ``dropout_key``, its
    kept values ``x / 0.95``."""
    import flax.linen as nn

    class Head(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dropout(0.05, deterministic=False)(x)

    class Top(nn.Module):
        def setup(self):
            self.head = Head()

        def __call__(self, x):
            return self.head(x)

    x = np.random.default_rng(0).uniform(0.5, 1.5, (16, 5120)).astype(np.float32)
    key = prng.prng_key(9)
    out = np.asarray(Top().apply({}, jnp.asarray(x), rngs={"dropout": jnp.asarray(key)}))
    mask = prng.bernoulli(prng.keys_tensor(prng.dropout_key(key, "head", 0)[None]),
                          (16, 5120), 0.95)[0].numpy().astype(bool)
    np.testing.assert_array_equal(out != 0, mask)
    expect = torch.where(torch.from_numpy(mask), torch.from_numpy(x) / (1.0 - 0.05),
                         torch.zeros(()))
    np.testing.assert_array_equal(out, expect.numpy())


def test_mask_keys_are_the_jax_uahn_heads_masks(monkeypatch):
    """The four masks a JAX ``UAHN`` call draws (captured where Flax's
    ``Dropout`` calls ``bernoulli``), in ``MASK_SITES`` order, equal the
    port's draws of ``mask_keys``: the path inside the JAX model is
    head_mean/Dropout_0, head_mean/Dropout_1, head_logvar/Dropout_0,
    head_logvar/Dropout_1, each at counter 1."""
    import flax.linen.stochastic as stochastic

    drawn = []
    bernoulli = stochastic.random.bernoulli

    def capture(rng, p, shape):
        mask = bernoulli(rng, p, shape)
        drawn.append((_data(rng), tuple(shape), np.asarray(mask)))
        return mask

    monkeypatch.setattr(stochastic.random, "bernoulli", capture)
    model = JaxUAHN(img_height=32, img_width=64)
    img = jnp.zeros((32, 64))
    params = model.init({"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
                        img, img)["params"]
    drawn.clear()
    model.apply({"params": params}, img, img, jnp.zeros((4, 2)), use_prior=True,
                rngs={"dropout": jax.random.PRNGKey(5)})
    assert [d[1] for d in drawn] == [(16, 256)] * 4  # fc input 256 at 32x64
    keys = prng.mask_keys(prng.prng_key(5))
    masks = prng.bernoulli(prng.keys_tensor(keys), (16, 256), 0.95)
    for (jax_key, _, jax_mask), key, mask in zip(drawn, keys, masks):
        np.testing.assert_array_equal(jax_key, key)
        np.testing.assert_array_equal(mask.numpy().astype(bool), jax_mask)


@pytest.fixture(scope="module")
def t_imu_to_cam():
    return np.asarray(VioOptions().t_imu_to_cam, np.float64)


def _frames_close(got: np.ndarray, want: np.ndarray):
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= FRAME_SHARE, (diff.max(), (diff > 0).mean())


def test_make_sequence_procedural_ground_matches_jax(t_imu_to_cam):
    kw = dict(duration=0.3, seed=3, texture_seed=4)
    want = jax_make_sequence(JaxTraj(), t_imu_to_cam, **kw)
    got = make_sequence(AnalyticTrajectory(), t_imu_to_cam, device="cpu", **kw)
    _frames_close(got.frames, want.frames)
    other = make_sequence(AnalyticTrajectory(), t_imu_to_cam, device="cpu",
                          **dict(kw, texture_seed=5))
    assert np.abs(other.frames.astype(int) - got.frames.astype(int)).mean() > 10


def test_make_sequence_effects_match_jax(t_imu_to_cam):
    """``--effects`` at effects seed 3 (a draw that is not the clean one:
    seeds 2, 5, 6 and 8 are): the parameters of
    ``draw_params(split(PRNGKey(3), 3)[0])`` and every frame's noise are
    the JAX package's."""
    k_par = prng.split(prng.prng_key(3), 3)[0]
    from cuahn_vio.data.sensor_effects import draw_params as jax_draw_params

    params = draw_params(EffectsConfig(), k_par[None], "cpu")[0].numpy()
    # the offset is a normal times 0.02: within 0.02 x 1e-6
    np.testing.assert_allclose(
        params, np.asarray(jax_draw_params(jnp.asarray(k_par), JaxEffectsConfig())),
        atol=2e-8, rtol=0)
    assert params[1] != 1.0  # not the neutral row: the chain and the noise run
    kw = dict(duration=0.3, seed=3, texture_seed=4, effects_seed=3)
    want = jax_make_sequence(JaxTraj(), t_imu_to_cam, effects=JaxEffectsConfig(), **kw)
    got = make_sequence(AnalyticTrajectory(), t_imu_to_cam, effects=EffectsConfig(),
                        device="cpu", **kw)
    _frames_close(got.frames, want.frames)
    clean = make_sequence(AnalyticTrajectory(), t_imu_to_cam, device="cpu", **kw)
    assert np.abs(clean.frames.astype(int) - got.frames.astype(int)).mean() > 2.0
