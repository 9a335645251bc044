"""H1, the UAHN's two MC-dropout heads as one kernel pair
(``ops/cuda/heads``): fc0 of both heads split over K, then a tail that sums
the splits in a fixed order and runs the bias, LeakyReLU, the second mask,
fc1 and the ensemble statistics.

On the CPU: the plain version against the UAHN's eager heads (``McHead``
and ``ensemble_statistics``) at B = 64, 19, 16 and 1; the dispatch
(``heads.takes``): H1 only on the card, in float32, with autograd off, at a
rate above 0 with masks, at fc0's shape 5120 -> 256, and a UAHN call sends
its heads to H1 exactly once; ``heads.cu`` itself built for the host by g++
(a fiber a CUDA thread, run in turn to each ``__syncthreads``) against the
plain version, its wide and narrow tilings the same bits, and a pair's
outputs the same bits at any batch size.

On the card (marked ``cuda``, skipped without one): H1 against its plain
version at B = 64, 19, 16 and 1, a pair's bits the same at each of those
batches, a replayed UAHN call bit for bit the eager call, the launches (2 a
call eager, captured or replayed; none under autograd or at rate 0), the
wrapper's refusals. On the GPU machine: ``python3 -m pytest --noconftest
tests/test_torch_heads.py``.

The tolerance, two float32 evaluations of the heads' function in other
orders of the same sums: ``heads.rounding_bounds`` (fc0's and fc1's sums
within ``conv.rounding_bound`` each, carried through the LeakyReLU, the
mask, fc1 and the statistics).
"""

import copy
import ctypes
import ctypes.util
import os
import re
import shutil
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cuahn_vio_torch.models.uahn import UAHN, draw_masks
from cuahn_vio_torch.ops import cuda as tcuda
from cuahn_vio_torch.ops.cuda import heads
from cuahn_vio_torch.ops.cuda.heads import HIDDEN, IN, MEMBERS, OUT
from test_torch_conv import HOST_SHIM

RATE = 0.05
BATCHES = (64, 19, 16, 1)  # close-loops, its ragged last call in the smoke, eval-flow, run-vio


def head_pair(seed: int, device="cpu"):
    """The UAHN's two heads with seeded weights of a trained head's scale."""
    torch.manual_seed(seed)
    model = UAHN(dropout_rate=RATE, img_height=224, img_width=320)
    with torch.no_grad():
        for head in (model.head_mean, model.head_logvar):
            head.fc0.bias.normal_(0.0, 0.05)
            head.fc1.weight.mul_(4.0)
            head.fc1.bias.normal_(0.0, 1.0)
    return model.to(device).eval()


def masks_of(b: int, seed: int, device="cpu"):
    """Keep-masks laid out as ``draw_masks`` lays them (each pair's four
    masks in one row of bytes), from numpy at the keep rate."""
    widths = (IN, HIDDEN, IN, HIDDEN)
    rng = np.random.default_rng(seed)
    rows = torch.as_tensor(rng.random((b, MEMBERS * sum(widths))) < 1.0 - RATE, device=device)
    starts = np.cumsum((0,) + tuple(MEMBERS * w for w in widths))
    m = [rows[:, starts[i]:starts[i + 1]].view(b, MEMBERS, w) for i, w in enumerate(widths)]
    return (m[0], m[1]), (m[2], m[3])


def features(b: int, seed: int, device="cpu"):
    """Block 4's features: LeakyReLU outputs of a trained tower's scale."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.2, 1.0, (b, IN)).astype(np.float32)
    return torch.as_tensor(np.where(x > 0, x, np.float32(0.1) * x), device=device)


def eager_heads(model, feat, masks):
    """The UAHN's heads op by op: ``_members``, then the statistics."""
    means, logvars = model._members(feat, masks)
    pred, var = heads.ensemble_statistics(means, logvars, model.corners)
    b = feat.shape[0]
    return (torch.stack([means.reshape(b, MEMBERS, OUT), logvars.reshape(b, MEMBERS, OUT)], 1),
            pred, var)


def kernel_order(model, feat, masks, exp=None):
    """H1's arithmetic op for op, the order of heads.cu's sums (each fma
    rounded once, ``ops/remap.fma_f32``): each K split's products in k
    order from 0, the splits in order, the bias, the LeakyReLU, the second
    mask; fc1's 32 lane sums (hidden units l + 32 j in order of j) added
    in the butterfly's pairs (l and l + 16, then l and l + 8, ..), the
    bias, the 1e-3; the members in order. ``exp``: the card's (torch.exp
    on CUDA tensors), or the host's C library ``expf`` by default.
    Returns (members, pred, var)."""
    from cuahn_vio_torch.ops.remap import fma_f32

    if exp is None:
        expf = ctypes.CDLL(ctypes.util.find_library("m")).expf
        expf.argtypes, expf.restype = [ctypes.c_float], ctypes.c_float
        exp = lambda t: torch.as_tensor(  # noqa: E731
            np.vectorize(expf, otypes=[np.float32])(t.numpy()))
    keep = torch.tensor(1.0 - RATE, dtype=torch.float32, device=feat.device)
    b, span = feat.shape[0], IN // heads.SPLITS
    outs = []
    for head, (m0, m1) in zip((model.head_mean, model.head_logvar), masks):
        x = torch.where(m0, feat[:, None, :] / keep, 0.0).reshape(-1, heads.SPLITS, span)
        w = head.fc0.weight.detach().reshape(HIDDEN, heads.SPLITS, span)
        acc = torch.zeros(heads.SPLITS, b * MEMBERS, HIDDEN, device=feat.device)
        for k in range(span):
            acc = fma_f32(x[:, :, k].T[:, :, None], w[:, :, k].T[:, None, :], acc)
        h = acc[0]
        for s in range(1, heads.SPLITS):
            h = h + acc[s]
        h = h + head.fc0.bias.detach()
        h = torch.where(h > 0, h, h * torch.tensor(0.1, device=feat.device))
        h = torch.where(m1.reshape(-1, HIDDEN), h / keep, 0.0)
        w1 = head.fc1.weight.detach()
        lanes = torch.zeros(b * MEMBERS, OUT, 32, device=feat.device)  # lane l: units l + 32 j
        for j in range(HIDDEN // 32):
            units = h[:, 32 * j:32 * (j + 1)]
            lanes = fma_f32(units[:, None, :], w1[None, :, 32 * j:32 * (j + 1)], lanes)
        while lanes.shape[-1] > 1:  # the butterfly: lane l + its partner at xor 16, 8, ..
            half = lanes.shape[-1] // 2
            lanes = lanes[..., :half] + lanes[..., half:]
        outs.append((lanes[..., 0] + head.fc1.bias.detach()).reshape(b, MEMBERS, OUT))
    outs[1] = outs[1] * torch.tensor(heads.LOGVAR_SCALE, device=feat.device)
    means, logvars = outs
    total = means[:, 0]
    for r in range(1, MEMBERS):
        total = total + means[:, r]
    mean = total * 0.0625
    d = means - mean[:, None]
    sq = d * d
    lv = torch.clamp(logvars, -heads.LOGVAR_CLAMP, heads.LOGVAR_CLAMP)
    ex = exp(lv)
    spread, expsum = sq[:, 0], ex[:, 0]
    for r in range(1, MEMBERS):
        spread, expsum = spread + sq[:, r], expsum + ex[:, r]
    pred = model.corners.reshape(1, OUT) + mean
    var = spread * 0.0625 + expsum * 0.0625
    return torch.stack(outs, 1), pred.reshape(b, 4, 2), var.reshape(b, 4, 2)


def assert_within(got, want, bounds, what=""):
    for g, w, lim, name in zip(got, want, bounds, ("members", "pred", "var")):
        assert g.shape == w.shape and torch.isfinite(g).all(), f"{what} {name}"
        err = (g - w).abs()
        assert bool(torch.all(err <= lim)), (
            f"{what} {name}: {float(err.max()):.3e} apart, "
            f"{float(torch.where(err == 0, 0.0, err / lim).max()):.2f}x the bound")


def _call(model, feat, masks, fn):
    pair = (model.head_mean, model.head_logvar)
    return fn(feat, masks, RATE, pair, model.corners)


@pytest.mark.parametrize("b", BATCHES)
def test_plain_is_the_uahn_heads(b):
    model = head_pair(b)
    feat, masks = features(b, b), masks_of(b, b)
    with torch.no_grad():
        got = _call(model, feat, masks, heads.heads_plain)
        want = eager_heads(model, feat, masks)
        bounds = heads.rounding_bounds(feat, masks, RATE, (model.head_mean, model.head_logvar),
                                       model.corners, want[0])
    assert_within(got, want, bounds, f"B = {b}")
    for g, p in zip(_call(model, feat, masks, heads.mc_heads), got):  # a CPU tensor: plain
        assert g.equal(p)


def _stand_in(device_type="cuda", dtype=torch.float32):
    return SimpleNamespace(device=torch.device(device_type, 0) if device_type == "cuda"
                           else torch.device(device_type), dtype=dtype)


@pytest.mark.parametrize("case,taken", [
    ("card", True), ("cpu", False), ("autograd", False), ("rate 0", False),
    ("no masks", False), ("bf16 features", False), ("fc0 4096 -> 256", False),
    ("fc0 5120 -> 128", False), ("bf16 heads", False)])
def test_takes(case, taken):
    model = head_pair(0)
    pair = [model.head_mean, model.head_logvar]
    masks, rate = masks_of(1, 0), RATE
    feat = _stand_in()
    if case == "cpu":
        feat = _stand_in("cpu")
    elif case == "bf16 features":
        feat = _stand_in(dtype=torch.bfloat16)
    elif case == "rate 0":
        masks, rate = None, 0.0
    elif case == "no masks":
        masks = None
    elif case.startswith("fc0"):
        n_in, n_out = (4096, 256) if "4096" in case else (IN, 128)
        pair[0] = copy.deepcopy(pair[0])
        pair[0].fc0 = torch.nn.Linear(n_in, n_out)
    elif case == "bf16 heads":
        pair[1] = copy.deepcopy(pair[1]).to(torch.bfloat16)
    with torch.set_grad_enabled(case == "autograd"):
        assert heads.takes(feat, masks, rate, pair) is taken


@pytest.fixture
def spy(monkeypatch):
    """``heads.takes`` as on the card for a CPU tensor, and a record of the
    batch sizes that went to H1 (run as its plain version)."""
    calls = []

    def takes_as_on_card(feat, masks, rate, pair):
        return takes(_stand_in(dtype=feat.dtype) if feat.device.type == "cpu" else feat,
                     masks, rate, pair)

    def recording(feat, masks, rate, pair, corners):
        calls.append(feat.shape[0])
        return mc_heads(feat, masks, rate, pair, corners)

    takes, mc_heads = heads.takes, heads.mc_heads
    monkeypatch.setattr(heads, "takes", takes_as_on_card)
    monkeypatch.setattr(heads, "mc_heads", recording)
    return calls


def _pairs(b, seed):
    """B random uint8 pairs at 224x320 (fc0's 5120 inputs)."""
    rng = np.random.default_rng(seed)
    img1 = torch.as_tensor(rng.integers(0, 256, (b, 224, 320)).astype(np.uint8))
    img2 = torch.as_tensor(rng.integers(0, 256, (b, 224, 320)).astype(np.uint8))
    prior = torch.as_tensor(rng.normal(0.0, 2.0, (b, 4, 2)).astype(np.float32))
    keys = np.stack([np.array([seed, i], np.uint32) for i in range(b)])
    return img1, img2, prior, keys


def test_a_uahn_call_sends_its_heads_to_h1_once(spy):
    torch.manual_seed(0)
    model = UAHN(dropout_rate=RATE).eval()
    img1, img2, prior, keys = _pairs(2, 3)
    before = dict(tcuda.launch_counts)
    got = model(img1, img2, prior, use_prior=True, dropout_keys=keys)
    model(img1, img2, None, use_prior=False, dropout_keys=keys)
    assert spy == [2, 2]
    assert tcuda.launch_counts == before  # the plain version launches nothing
    spy.clear()
    want = model.flow_and_cov(img1, img2, prior, True, keys)  # autograd records: McHead
    assert spy == []
    for g, w in zip(got, want):
        assert torch.allclose(g, w, rtol=1e-4, atol=1e-4)
    UAHN(dropout_rate=0.0).eval()(img1, img2, prior, use_prior=True)
    assert spy == []  # rate 0: no masks, McHead passes the features through


def test_bf16_towers_send_float32_features_to_h1(spy):
    torch.manual_seed(0)
    bf16 = UAHN(dropout_rate=RATE, compute_dtype=torch.bfloat16).eval()
    img1, img2, prior, keys = _pairs(1, 4)
    bf16(img1, img2, prior, use_prior=True, dropout_keys=keys)
    assert spy == [1]


# ---------------------------------------------------- H1 built for the host

HOST_EXTRA = r"""
struct uint2 { unsigned x, y; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsub_rn(float a, float b) { return a - b; }
// a warp's exchange: every thread of the block shuffles together (the
// kernels shuffle in whole blocks), each value posted, then read
static float host_lanes[1024];
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  host_lanes[threadIdx.x] = v;
  __syncthreads();
  const float got = host_lanes[threadIdx.x ^ lane_mask];
  __syncthreads();
  return got;
}
#include <functional>
#include <vector>
#include <ucontext.h>
static std::function<void()>* host_body;
static std::vector<char>* host_done;
static void host_fiber(int t) {
  (*host_body)();
  (*host_done)[t] = 1;
}
// a grid of blocks, one after another; a block's threads as fibers of one
// host thread, each run in turn to its next __syncthreads, on shared memory
// filled with NaNs (a word read before it is written shows)
template <class F>
void host_launch(dim3 grid, unsigned threads, size_t smem_bytes, cudaStream_t, F kernel) {
  std::function<void()> body = kernel;
  std::vector<ucontext_t> fibers(threads);
  std::vector<std::vector<char>> stacks(threads, std::vector<char>(1 << 16));
  std::vector<char> done(threads);
  host_body = &body;
  host_done = &done;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::vector<float> smem(smem_bytes / 4, NAN);
        host_smem = smem.data();
        blockIdx = {bx, by, bz};
        for (unsigned t = 0; t < threads; ++t) {
          getcontext(&fibers[t]);
          fibers[t].uc_stack.ss_sp = stacks[t].data();
          fibers[t].uc_stack.ss_size = stacks[t].size();
          fibers[t].uc_link = &host_main;
          makecontext(&fibers[t], reinterpret_cast<void (*)()>(host_fiber), 1,
                      static_cast<int>(t));
          done[t] = 0;
        }
        for (unsigned left = threads; left > 0;) {
          for (unsigned t = 0; t < threads; ++t) {
            if (done[t]) continue;
            threadIdx = {t, 0, 0};
            host_self = &fibers[t];
            swapcontext(&host_main, &fibers[t]);
            left -= done[t];
          }
        }
      }
}
"""


def host_source(src: str) -> str:
    """``heads.cu`` for the host: the shim for CUDA's few names, shared
    memory a buffer a block, each launch a call of ``host_launch``."""
    rewrites = [  # (regular expression, replacement, how many)
        (re.escape("#include <cuda_runtime.h>"), (HOST_SHIM + HOST_EXTRA).replace("\\", "\\\\"),
         1),
        (re.escape("extern __shared__ __align__(16) float smem[];"), "float* smem = host_smem;",
         2),
        (r"(mc_heads_\w+_kernel(?:<[^<>]*>)?)\s*<<<(.*?)>>>\((.*?)\);",
         r"host_launch(\2, [&] { \1(\3); });", 2),
    ]
    for pattern, repl, count in rewrites:
        src, n = re.subn(pattern, repl, src, flags=re.S)
        assert n == count, f"heads.cu is not as the host build expects: {pattern[:48]}"
    return src


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels' source for the host")
    tmp = tmp_path_factory.mktemp("heads_host")
    with open(heads.SOURCE) as f:
        (tmp / "heads_host.cpp").write_text(host_source(f.read()))
    lib = tmp / "libheads_host.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-o",
                    str(lib), str(tmp / "heads_host.cpp")], check=True, timeout=300)
    host = ctypes.CDLL(str(lib))
    host.mc_heads_f32.argtypes = list(heads._ARGS)
    host.mc_heads_f32.restype = ctypes.c_int
    host.mc_heads_splits.restype = ctypes.c_int
    host.host_set_sms.argtypes = [ctypes.c_int]
    return host


def _host_run(host, model, feat, masks, stride=None, keep=1.0 - RATE):
    """(members, pred, var) of the host build, NaN where it wrote nothing;
    or its error code, where it is not 0."""
    b = feat.shape[0]
    pair = (model.head_mean, model.head_logvar)
    params = [p.detach() for h in pair for p in (h.fc0.weight, h.fc0.bias, h.fc1.weight,
                                                  h.fc1.bias)]
    ws = torch.full((2, heads.SPLITS, b * MEMBERS, HIDDEN), float("nan"))
    outs = [torch.full(s, float("nan")) for s in ((b, 2, MEMBERS, OUT), (b, 4, 2), (b, 4, 2))]
    (m0m, m1m), (m0l, m1l) = masks
    err = host.mc_heads_f32(feat.data_ptr(), *(p.data_ptr() for p in params), m0m.data_ptr(),
                            m1m.data_ptr(), m0l.data_ptr(), m1l.data_ptr(),
                            m0m.stride(0) if stride is None else stride, model.corners.data_ptr(),
                            ws.data_ptr(), *(o.data_ptr() for o in outs), b, keep, None)
    return outs if err == 0 else err


def test_kernel_on_the_host_is_the_plain_version(host_kernel):
    """Both tilings (a card of one SM: the wide one; of more SMs than any
    grid has blocks: the narrow one) at B = 3, within the bound of the plain
    version, the same bits as its arithmetic done op for op in its order
    (``kernel_order``) and as each other, and pair 1 alone the same bits as
    its row of the batch."""
    assert host_kernel.mc_heads_splits() == heads.SPLITS
    model = head_pair(7)
    feat, masks = features(3, 7), masks_of(3, 7)
    try:
        host_kernel.host_set_sms(1)
        wide = _host_run(host_kernel, model, feat, masks)
        host_kernel.host_set_sms(1 << 20)
        narrow = _host_run(host_kernel, model, feat, masks)
        one = _host_run(host_kernel, model, feat[1:2].contiguous(),
                        tuple((m0[1:2], m1[1:2]) for m0, m1 in masks))
    finally:
        host_kernel.host_set_sms(1)
    with torch.no_grad():
        want = _call(model, feat, masks, heads.heads_plain)
        bounds = heads.rounding_bounds(feat, masks, RATE, (model.head_mean, model.head_logvar),
                                       model.corners, want[0])
    assert_within(wide, want, bounds, "wide")
    with torch.no_grad():
        exact = kernel_order(model, feat, masks)
    for w, n, o, e in zip(wide, narrow, one, exact):
        assert w.equal(e) and w.equal(n) and w[1:2].equal(o)


def test_kernel_on_the_host_refuses_what_it_does_not_take(host_kernel):
    model = head_pair(8)
    feat, masks = features(1, 8), masks_of(1, 8)
    invalid = 1  # the shim's cudaErrorInvalidValue
    assert _host_run(host_kernel, model, feat, masks, stride=masks[0][0].stride(0) - 4) == invalid
    assert _host_run(host_kernel, model, feat, masks, stride=IN) == invalid  # rows overlap
    assert _host_run(host_kernel, model, feat, masks, keep=0.0) == invalid
    assert _host_run(host_kernel, model, feat[:0], tuple((a[:0], b[:0]) for a, b in masks)) == (
        invalid)


# ------------------------------------------------------------------ the card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: H1 is a pair of CUDA kernels with no CPU mode")
    from cuahn_vio_torch.ops.homography import f32_parity_mode

    f32_parity_mode()
    return torch.device("cuda:0")


def _card_inputs(card, b, seed):
    model = head_pair(seed, card)
    keys = np.stack([np.array([seed, i], np.uint32) for i in range(b)])
    return model, features(b, seed, card), draw_masks(keys, RATE, IN, card, b)


@pytest.mark.cuda
@pytest.mark.parametrize("b", BATCHES)
def test_kernel_is_its_plain_version(card, b):
    model, feat, masks = _card_inputs(card, b, 11)
    before = tcuda.launch_counts["mc_heads"]
    with torch.no_grad():
        got = _call(model, feat, masks, heads.mc_heads_cuda)
        assert tcuda.launch_counts["mc_heads"] == before + heads.LAUNCHES
        want = _call(model, feat, masks, heads.heads_plain)
        bounds = heads.rounding_bounds(feat, masks, RATE, (model.head_mean, model.head_logvar),
                                       model.corners, want[0])
        exact = kernel_order(model, feat, masks, torch.exp)
    torch.cuda.synchronize()
    assert_within(got, want, bounds, f"B = {b}")
    # its arithmetic op for op: the same bits, but where exp rounds (torch's
    # exp against the kernel's expf: a few ulp of each term at most)
    assert got[0].equal(exact[0]) and got[1].equal(exact[1])
    assert bool(torch.all((got[2] - exact[2]).abs() <= 64 * heads.U * exact[2].abs()))


@pytest.mark.cuda
def test_a_pair_is_the_same_bits_at_any_batch(card):
    model, feat, masks = _card_inputs(card, 64, 12)

    def rows(lo, hi):
        return _call(model, feat[lo:hi].contiguous(),
                     tuple((m0[lo:hi], m1[lo:hi]) for m0, m1 in masks), heads.mc_heads_cuda)

    with torch.no_grad():
        full = rows(0, 64)
        for lo, hi in ((5, 24), (40, 56), (63, 64), (0, 1)):
            for part, whole in zip(rows(lo, hi), full):
                assert part.equal(whole[lo:hi]), (lo, hi)


@pytest.fixture(scope="module")
def uahn(card):
    from cuahn_vio_torch.models.uahn import build_uahn
    from cuahn_vio_torch.utils.checkpoint import load_params

    weights = os.path.join(os.path.dirname(__file__), "..", "weights", "uahn_fil_v10.msgpack")
    return build_uahn(load_params(weights), device=card)


def _uahn_pairs(b, seed, device):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (b, 232, 328)).astype(np.uint8)
    img1 = torch.as_tensor(base[:, 4:228, 4:324].copy(), device=device)
    img2 = torch.as_tensor(base[:, 2:226, 3:323].copy(), device=device)
    prior = torch.as_tensor(rng.normal(0.0, 2.0, (b, 4, 2)).astype(np.float32), device=device)
    keys = np.stack([np.array([seed, i], np.uint32) for i in range(b)])
    return img1, img2, prior, keys


@pytest.mark.cuda
@pytest.mark.parametrize("b", [64, 1])
def test_a_replay_is_the_eager_call_with_its_launches(uahn, b):
    from cuahn_vio_torch.models import uahn_graphs

    net = copy.deepcopy(uahn)
    net._graphs = uahn_graphs.GraphCache()
    img1, img2, prior, keys = _uahn_pairs(b, 13, uahn.corners.device)
    outs, moved = [], []
    for _ in range(3):  # eager, captured, replayed
        before = tcuda.launch_counts["mc_heads"]
        outs.append(net(img1, img2, prior, use_prior=True, dropout_keys=keys))
        moved.append(tcuda.launch_counts["mc_heads"] - before)
    torch.cuda.synchronize()
    assert len(net._graphs.captured()) == 1
    assert moved == [heads.LAUNCHES] * 3
    for out in outs[1:]:
        assert out[0].equal(outs[0][0]) and out[1].equal(outs[0][1])


@pytest.mark.cuda
def test_no_launch_under_autograd_or_at_rate_0(uahn):
    img1, img2, prior, keys = _uahn_pairs(4, 14, uahn.corners.device)
    before = tcuda.launch_counts["mc_heads"]
    with torch.enable_grad():
        uahn.flow_and_cov(img1, img2, prior, True, keys)
    still = copy.deepcopy(uahn)
    still.dropout_rate = 0.0
    still(img1, img2, prior, use_prior=True)
    torch.cuda.synchronize()
    assert tcuda.launch_counts["mc_heads"] == before


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(card):
    model, feat, masks = _card_inputs(card, 2, 15)
    pair = (model.head_mean, model.head_logvar)
    with pytest.raises(ValueError):  # features not contiguous
        heads.mc_heads_cuda(feat.T.contiguous().T, masks, RATE, pair, model.corners)
    with pytest.raises(ValueError):  # masks of two buffers
        heads.mc_heads_cuda(feat, (masks[0], tuple(m.clone() for m in masks[1])), RATE, pair,
                            model.corners)
    with pytest.raises(ValueError):
        heads.mc_heads_cuda(feat.cpu(), masks, RATE, pair, model.corners)
    with pytest.raises(ValueError):
        heads.mc_heads_cuda(feat.half(), masks, RATE, pair, model.corners)
    with pytest.raises(ValueError):
        heads.mc_heads_cuda(feat, masks, 0.0, pair, model.corners)
