"""V1, the towers' low-channel convolution (``ops/cuda/conv``).

On the CPU: the plain version against ``leaky_relu(conv2d(...))`` at each
of V1's layer shapes; the towers' dispatch (``conv.takes``): a layer goes
to V1 only on the card, in float32, with autograd off, at one of V1's
shapes, and a UAHN call sends exactly its three such layers there.

On the card (marked ``cuda``, skipped without one): V1 against its plain
version at B = 64, 8 and 1 and on ragged sizes, and the wrapper's refusals.
On the GPU machine: ``python3 -m pytest --noconftest tests/test_torch_conv.py``.

The tolerance, V1 or the plain version against another order of the same
float32 sums of n = c_in k^2 <= 200 products and a bias: ``conv.rounding_bound``,
twice (n + 2) u of the terms' magnitudes (u = 2^-24), per output.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cuahn_vio_torch.models.uahn import UAHN, ConvTower
from cuahn_vio_torch.ops import cuda as tcuda
from cuahn_vio_torch.ops.cuda import conv

# (c_in, c_out, k, stride): block 4's conv0 and conv1, block 3's conv0
LAYERS = {"block4.conv0": (2, 8, 7, 1), "block4.conv1": (8, 16, 5, 2),
          "block3.conv0": (2, 16, 7, 1)}
# the towers' other layer shapes, which stay on conv2d
OTHERS = [(2, 64, 7, 2), (2, 128, 7, 2), (16, 32, 5, 2), (16, 32, 3, 2), (256, 256, 3, 2)]


def layer_inputs(shape, b, h, w, seed, device="cpu"):
    """Seeded (x, weight, bias) of a layer shape: x in [-0.5, 1.5), the
    weights and biases of a trained tower's scale."""
    c_in, c_out, k, _ = shape
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 1.5, (b, c_in, h, w)).astype(np.float32)
    wt = (rng.normal(0.0, 1.0, (c_out, c_in, k, k)) / np.sqrt(c_in * k * k)).astype(np.float32)
    bias = rng.normal(0.0, 0.1, c_out).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (x, wt, bias))


def within(got, want, lim):
    err = (got - want).abs()
    return bool(torch.all(err <= lim))


@pytest.mark.parametrize("label", list(LAYERS))
@pytest.mark.parametrize("b,h,w", [(2, 20, 28), (1, 9, 11), (3, 5, 3)])
def test_plain_is_conv_then_leaky_relu(label, b, h, w):
    shape = LAYERS[label]
    x, wt, bias = layer_inputs(shape, b, h, w, seed=100 * list(LAYERS).index(label) + h)
    got = conv.lowc_conv_plain(x, wt, bias, shape[3])
    want = F.leaky_relu(F.conv2d(x, wt, bias, shape[3], (shape[2] - 1) // 2), 0.1)
    assert got.shape == want.shape
    assert within(got, want, conv.rounding_bound(x, wt, bias, shape[3]))
    assert conv.lowc_conv(x, wt, bias, shape[3]).equal(got)  # a CPU tensor takes the plain version


def test_plain_refuses_other_shapes():
    x, wt, bias = layer_inputs((16, 32, 3, 2), 1, 8, 8, seed=1)
    with pytest.raises(ValueError):
        conv.lowc_conv_plain(x, wt, bias, 2)
    x, wt, bias = layer_inputs(LAYERS["block4.conv0"], 1, 8, 8, seed=1)
    with pytest.raises(ValueError):
        conv.lowc_conv_plain(x, wt, bias, 2)  # the shape's stride is 1
    with pytest.raises(ValueError):
        conv.lowc_conv_plain(x.double(), wt.double(), bias.double(), 1)


def _layer(shape):
    c_in, c_out, k, s = shape
    return torch.nn.Conv2d(c_in, c_out, k, s, (k - 1) // 2)


CARD = torch.device("cuda", 0)  # a device object: no card needed to build it


@pytest.mark.parametrize("shape", list(LAYERS.values()))
def test_takes_v1_layers_on_the_card_in_float32_without_autograd(shape):
    layer = _layer(shape)
    with torch.no_grad():
        assert conv.takes(CARD, torch.float32, layer)
        assert not conv.takes(torch.device("cpu"), torch.float32, layer)
        assert not conv.takes(CARD, torch.bfloat16, layer)
    with torch.enable_grad():
        assert not conv.takes(CARD, torch.float32, layer)


@pytest.mark.parametrize("shape", OTHERS)
def test_takes_no_other_layer(shape):
    with torch.no_grad():
        assert not conv.takes(CARD, torch.float32, _layer(shape))


@pytest.fixture
def spy(monkeypatch):
    """``conv.takes`` as on the card for a CPU tensor, and a record of the
    layer shapes that went to ``conv.lowc_conv`` (run as the plain
    version)."""
    calls = []
    takes = conv.takes
    lowc_conv = conv.lowc_conv

    def takes_as_on_card(device, dtype, layer):
        return takes(CARD if device.type == "cpu" else device, dtype, layer)

    def recording(x, w, b, stride):
        calls.append((w.shape[1], w.shape[0], w.shape[2], stride))
        return lowc_conv(x, w, b, stride)

    monkeypatch.setattr(conv, "takes", takes_as_on_card)
    monkeypatch.setattr(conv, "lowc_conv", recording)
    return calls


def _pair_call(model, seed=0):
    rng = np.random.default_rng(seed)
    b, h, w = 2, model.img_height, model.img_width
    img1 = torch.as_tensor(rng.integers(0, 256, (b, h, w)).astype(np.uint8))
    img2 = torch.as_tensor(rng.integers(0, 256, (b, h, w)).astype(np.uint8))
    prior = torch.as_tensor(rng.normal(0.0, 2.0, (b, 4, 2)).astype(np.float32))
    keys = np.stack([np.array([0, i], np.uint32) for i in range(b)])
    return img1, img2, prior, keys


def test_a_uahn_call_sends_its_three_layers_to_v1(spy):
    torch.manual_seed(0)
    model = UAHN(dropout_rate=0.05, img_height=64, img_width=64).eval()
    img1, img2, prior, keys = _pair_call(model)
    got = model(img1, img2, prior, use_prior=True, dropout_keys=keys)
    # block 3's conv0, then block 4's conv0 and conv1; blocks 2's and the
    # other layers stay on conv2d
    assert spy == [LAYERS["block3.conv0"], LAYERS["block4.conv0"], LAYERS["block4.conv1"]]
    spy.clear()
    want = model.flow_and_cov(img1, img2, prior, True, keys)
    # flow_and_cov records autograd through block 4: only block 3's layer,
    # inside the no-grad refinements, goes to V1 there
    assert spy == [LAYERS["block3.conv0"]]
    for g, w in zip(got, want):
        assert torch.allclose(g, w, rtol=1e-4, atol=1e-4)


def test_full_cascade_and_bf16_towers(spy):
    torch.manual_seed(0)
    model = UAHN(dropout_rate=0.05, img_height=64, img_width=64).eval()
    img1, img2, prior, keys = _pair_call(model, 1)
    model(img1, img2, None, use_prior=False, dropout_keys=keys)  # block 1's layers stay on conv2d
    assert spy == [LAYERS["block3.conv0"], LAYERS["block4.conv0"], LAYERS["block4.conv1"]]
    spy.clear()
    bf16 = UAHN(dropout_rate=0.05, compute_dtype=torch.bfloat16, img_height=64,
                img_width=64).eval()
    bf16(img1, img2, prior, use_prior=True, dropout_keys=keys)
    assert spy == []


def test_tower_is_conv2d_on_the_cpu():
    """Off the card the tower is conv2d and leaky_relu, as before V1."""
    torch.manual_seed(0)
    tower = ConvTower(2, [(8, 7, 1), (16, 5, 2), (32, 3, 2)])
    x = torch.rand(2, 2, 24, 32)
    before = dict(tcuda.launch_counts)
    with torch.no_grad():
        got = tower(x)
    want = x
    for layer in tower.children():
        want = F.leaky_relu(F.conv2d(want, layer.weight, layer.bias, layer.stride,
                                     layer.padding), 0.1)
    assert got.equal(want)
    assert tcuda.launch_counts == before


# ------------------------------------------------------------------ the card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: V1 is a CUDA kernel with no CPU mode")
    from cuahn_vio_torch.ops.homography import f32_parity_mode

    f32_parity_mode()
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(LAYERS))
@pytest.mark.parametrize("b", [64, 8, 1])
def test_v1_is_its_plain_version(card, label, b):
    shape = LAYERS[label]
    h, w = (112, 160) if label == "block3.conv0" else (224, 320)
    x, wt, bias = layer_inputs(shape, b, h, w, seed=b, device=card)
    before = tcuda.launch_counts["lowc_conv"]
    got = conv.lowc_conv(x, wt, bias, shape[3])
    assert tcuda.launch_counts["lowc_conv"] == before + 1
    want = conv.lowc_conv_plain(x, wt, bias, shape[3])
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert within(got, want, conv.rounding_bound(x, wt, bias, shape[3]))


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(LAYERS))
@pytest.mark.parametrize("b,h,w", [(3, 37, 53), (2, 5, 3), (2, 9, 11), (1, 225, 321)])
def test_v1_at_ragged_sizes(card, label, b, h, w):
    shape = LAYERS[label]
    x, wt, bias = layer_inputs(shape, b, h, w, seed=h, device=card)
    got = conv.lowc_conv_cuda(x, wt, bias, shape[3])
    want = conv.lowc_conv_plain(x, wt, bias, shape[3])
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert within(got, want, conv.rounding_bound(x, wt, bias, shape[3]))


@pytest.mark.cuda
def test_v1_refuses_what_it_does_not_take(card):
    x, wt, bias = layer_inputs(LAYERS["block4.conv0"], 2, 16, 20, seed=3, device=card)
    with pytest.raises(ValueError):
        conv.lowc_conv_cuda(x[..., ::2], wt, bias, 1)  # not contiguous
    with pytest.raises(ValueError):
        conv.lowc_conv_cuda(x.half(), wt.half(), bias.half(), 1)
    with pytest.raises(ValueError):
        conv.lowc_conv_cuda(x.cpu(), wt, bias, 1)
    with pytest.raises(ValueError):
        conv.lowc_conv_cuda(x, wt, bias, 2)
