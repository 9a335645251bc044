"""The towers' fused convolutions (``ops/cuda/conv``): V1, the low-channel
convolution (``conv.cu``), and V2, the implicit GEMM (``conv_gemm.cu``),
each layer shape sent to its kernel by one table, ``conv.SHAPES``.

On the CPU: each kernel's plain version against ``leaky_relu(conv2d(...))``
at each of its shapes; the towers' dispatch (``conv.takes``): a layer goes
to its shape's kernel only on the card, in float32, with autograd off, the
table holds the towers' layers of blocks 2-4 and block 1's conv2 and
nothing else, and a UAHN call sends exactly its three layers to V1 and its
fourteen of blocks 2-4 to V2 (fifteen in the full cascade: block 1's conv2
has block 2's conv2's shape); ``conv_gemm.cu`` itself built for the host by
g++ (a fiber a CUDA thread, run in turn to each ``__syncthreads``, the
copies done at once) against the plain version, its wide and narrow
tilings the same bits, and a pair's outputs the same bits at any batch
size.

On the card (marked ``cuda``, skipped without one): each kernel against its
plain version at B = 64, 16, 8, 1 and a ragged B, and at ragged sizes; a
pair's row of a B = 64 launch bit for bit its B = 1 launch; a replayed UAHN
call bit for bit the eager call, with each kernel's launches; a weight
changed in place read at the next replay; the wrapper's refusals. On the
GPU machine: ``python3 -m pytest --noconftest tests/test_torch_conv.py``.

The tolerance, a kernel or its plain version against another order of the
same float32 sums of n = c_in k^2 <= 2,304 products and a bias:
``conv.rounding_bound``, twice (n + 2) u of the terms' magnitudes
(u = 2^-24), per output.
"""

import copy
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cuahn_vio_torch.models.uahn import UAHN, ConvTower
from cuahn_vio_torch.ops import cuda as tcuda
from cuahn_vio_torch.ops.cuda import conv

# (c_in, c_out, k, stride) -> (its kernel, its first layer in the towers,
# that layer's input (H, W) at 224x320 frames)
LAYERS = {
    (2, 8, 7, 1): ("V1", "block4.conv0", (224, 320)),
    (8, 16, 5, 2): ("V1", "block4.conv1", (224, 320)),
    (2, 16, 7, 1): ("V1", "block3.conv0", (112, 160)),
    (2, 64, 7, 2): ("V2", "block2.conv0", (56, 80)),
    (64, 128, 5, 2): ("V2", "block2.conv1", (28, 40)),
    (16, 32, 5, 2): ("V2", "block3.conv1", (112, 160)),
    (16, 32, 3, 2): ("V2", "block4.conv2", (112, 160)),
    (32, 64, 3, 2): ("V2", "block3.conv2", (56, 80)),  # and block 4 conv3
    (64, 128, 3, 2): ("V2", "block3.conv3", (28, 40)),  # and block 4 conv4
    (128, 256, 3, 2): ("V2", "block2.conv2", (14, 20)),  # and block 3 conv4, block 4 conv5
    (256, 256, 3, 2): ("V2", "block2.conv3", (7, 10)),  # and block 3 conv5, block 4 conv6
}
SHAPES = list(LAYERS)
IDS = [f"{name}-{label}" for name, label, _ in LAYERS.values()]
V2_SHAPES = [s for s in SHAPES if LAYERS[s][0] == "V2"]
KERNELS = {"V1": conv.V1, "V2": conv.V2}
# V2's split path (V2K): its shapes, each to the runs of c_in that its K is
# split into across blocks
SPLIT = {(128, 256, 3, 2): 4, (256, 256, 3, 2): 6}
# each split's sums there (conv_gemm.cu's Tiling): a block's groups of
# threads (KS) and the k rows a group takes of each stage's KS x BK (BK)
GROUPS = {(128, 256, 3, 2): (2, 12), (256, 256, 3, 2): (2, 12)}
SPLIT_SHAPES = list(SPLIT)
SPLIT_IDS = [f"V2K-{LAYERS[s][1]}" for s in SPLIT_SHAPES]


def kernel_of(shape):
    """The table's kernel of a layer shape: V2K on the split path."""
    return conv.V2K if shape in SPLIT else KERNELS[LAYERS[shape][0]]
# block 1's conv0 and conv1, and shapes of no tower layer: they stay on conv2d
OTHERS = [(2, 128, 7, 2), (128, 128, 5, 2), (2, 8, 7, 2), (16, 32, 3, 1), (2, 8, 5, 1),
          (3, 8, 7, 1)]


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
    return bool(torch.all((got - want).abs() <= lim))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("b,h,w", [(2, 20, 28), (2, 14, 20), (1, 9, 11), (3, 5, 3)])
def test_plain_is_conv_then_leaky_relu(shape, b, h, w):
    x, wt, bias = layer_inputs(shape, b, h, w, seed=10 * SHAPES.index(shape) + h)
    got = kernel_of(shape).plain(x, wt, bias, shape[3])
    want = F.leaky_relu(F.conv2d(x, wt, bias, shape[3], (shape[2] - 1) // 2), 0.1)
    assert got.shape == want.shape
    assert within(got, want, conv.rounding_bound(x, wt, bias, shape[3]))
    assert conv.conv_leaky(x, wt, bias, shape[3]).equal(got)  # a CPU tensor takes the plain version


# a kernel's own shape, and one of the other kernel's, which it refuses
OWN_AND_OTHER = {"V1": ((2, 8, 7, 1), (16, 32, 3, 2)), "V2": ((16, 32, 3, 2), (2, 8, 7, 1))}


@pytest.mark.parametrize("name", list(KERNELS))
def test_plain_refuses_other_shapes(name):
    plain, (own, other) = KERNELS[name].plain, OWN_AND_OTHER[name]
    x, wt, bias = layer_inputs(other, 1, 8, 8, seed=1)
    with pytest.raises(ValueError):
        plain(x, wt, bias, other[3])
    x, wt, bias = layer_inputs(own, 1, 8, 8, seed=1)
    with pytest.raises(ValueError):
        plain(x, wt, bias, 3 - own[3])  # the shape's stride is the other one
    with pytest.raises(ValueError):
        plain(x.double(), wt.double(), bias.double(), own[3])
    x, wt, bias = layer_inputs(OTHERS[0], 1, 8, 8, seed=1)
    with pytest.raises(ValueError):
        conv.conv_leaky(x, wt, bias, 2)  # block 1's conv0: no kernel's


def _layer(shape, padding=None):
    c_in, c_out, k, s = shape
    return torch.nn.Conv2d(c_in, c_out, k, s, (k - 1) // 2 if padding is None else padding)


CARD = torch.device("cuda", 0)  # a device object: no card needed to build it


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_each_shape_goes_to_its_kernel_on_the_card_in_float32_without_autograd(shape):
    assert conv.SHAPES[shape] is kernel_of(shape)
    assert conv.SHAPES[shape].splits.get(shape, 1) == SPLIT.get(shape, 1)
    layer = _layer(shape)
    with torch.no_grad():
        assert conv.takes(CARD, torch.float32, layer)
        assert not conv.takes(torch.device("cpu"), torch.float32, layer)
        assert not conv.takes(CARD, torch.bfloat16, layer)
        assert not conv.takes(CARD, torch.float32, _layer(shape, padding=0))
    with torch.enable_grad():
        assert not conv.takes(CARD, torch.float32, layer)


@pytest.mark.parametrize("shape", OTHERS)
def test_takes_no_other_layer(shape):
    with torch.no_grad():
        assert not conv.takes(CARD, torch.float32, _layer(shape))


def test_the_table_holds_the_towers_layers_of_blocks_2_to_4_and_block1_conv2():
    model = UAHN(img_height=64, img_width=64)
    shapes = {name: (c.in_channels, c.out_channels, c.kernel_size[0], c.stride[0])
              for name, c in model.named_modules() if isinstance(c, torch.nn.Conv2d)}
    assert len(shapes) == 3 + 4 + 6 + 7  # blocks 1-4
    taken = {s for name, s in shapes.items() if not name.startswith("block1.")}
    assert set(conv.SHAPES) == taken | {shapes["block1.conv2"]} == set(LAYERS)
    assert shapes["block1.conv0"] not in conv.SHAPES and shapes["block1.conv1"] not in conv.SHAPES
    assert set(conv.SHAPES.values()) == set(conv.KERNELS)


@pytest.fixture
def spy(monkeypatch):
    """``conv.takes`` as on the card for a CPU tensor, and a record of the
    layer shapes that went to each kernel through ``conv.conv_leaky`` (run
    as its plain version)."""
    calls = {name: [] for name in [*KERNELS, "V2K"]}
    takes, conv_leaky = conv.takes, conv.conv_leaky

    def takes_as_on_card(device, dtype, layer):
        return takes(CARD if device.type == "cpu" else device, dtype, layer)

    def recording(x, w, b, stride):
        shape = (w.shape[1], w.shape[0], w.shape[2], stride)
        calls[conv.SHAPES[shape].label].append(shape)
        if conv.SHAPES[shape] is conv.V2K:
            calls["V2K"].append(shape)
        return conv_leaky(x, w, b, stride)

    monkeypatch.setattr(conv, "takes", takes_as_on_card)
    monkeypatch.setattr(conv, "conv_leaky", recording)
    return calls


def _pair_call(model, seed=0):
    rng = np.random.default_rng(seed)
    b, h, w = 2, model.img_height, model.img_width
    img1 = torch.as_tensor(rng.integers(0, 256, (b, h, w)).astype(np.uint8))
    img2 = torch.as_tensor(rng.integers(0, 256, (b, h, w)).astype(np.uint8))
    prior = torch.as_tensor(rng.normal(0.0, 2.0, (b, 4, 2)).astype(np.float32))
    keys = np.stack([np.array([0, i], np.uint32) for i in range(b)])
    return img1, img2, prior, keys


# the layers of blocks 2, 3 and 4 that V2 takes, in the order a call runs them
BLOCK2 = [(2, 64, 7, 2), (64, 128, 5, 2), (128, 256, 3, 2), (256, 256, 3, 2)]
BLOCK3 = [(16, 32, 5, 2), (32, 64, 3, 2), (64, 128, 3, 2), (128, 256, 3, 2), (256, 256, 3, 2)]
BLOCK4 = [(16, 32, 3, 2), (32, 64, 3, 2), (64, 128, 3, 2), (128, 256, 3, 2), (256, 256, 3, 2)]
# each kernel's layers of a prior-mode call, in order: V1 block 3's conv0,
# then block 4's conv0 and conv1; V2 the others of blocks 2-4
SENT = {"V1": [(2, 16, 7, 1), (2, 8, 7, 1), (8, 16, 5, 2)], "V2": BLOCK2 + BLOCK3 + BLOCK4}
# those of them inside the no-grad refinements (blocks 2 and 3), the only
# ones ``flow_and_cov`` sends: it records autograd through block 4
NO_GRAD = {"V1": [(2, 16, 7, 1)], "V2": BLOCK2 + BLOCK3}
# the full cascade's block 1: its conv2 has block 2's conv2's shape, its
# conv0 and conv1 stay on conv2d
BLOCK1 = {"V1": [], "V2": [(128, 256, 3, 2)]}
for _sent in (SENT, NO_GRAD, BLOCK1):  # V2's layers that take its split path
    _sent["V2K"] = [s for s in _sent["V2"] if s in SPLIT]


@pytest.mark.parametrize("name,launches", [("V1", 3), ("V2", 14), ("V2K", 6)],
                         ids=["V1-3", "V2-14", "V2K-6"])
def test_a_uahn_call_sends_its_layers(spy, name, launches):
    torch.manual_seed(0)
    model = UAHN(dropout_rate=0.05, img_height=64, img_width=64).eval()
    img1, img2, prior, keys = _pair_call(model)
    got = model(img1, img2, prior, use_prior=True, dropout_keys=keys)
    assert spy[name] == SENT[name] and len(spy[name]) == launches
    spy[name].clear()
    want = model.flow_and_cov(img1, img2, prior, True, keys)
    assert spy[name] == NO_GRAD[name]
    for g, w in zip(got, want):
        assert torch.allclose(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,launches", [("V1", 3), ("V2", 15), ("V2K", 7)],
                         ids=["V1-3", "V2-15", "V2K-7"])
def test_the_full_cascade_sends_its_layers(spy, name, launches):
    torch.manual_seed(0)
    model = UAHN(dropout_rate=0.05, img_height=64, img_width=64).eval()
    img1, img2, _, keys = _pair_call(model, 1)
    model(img1, img2, None, use_prior=False, dropout_keys=keys)
    assert spy[name] == BLOCK1[name] + SENT[name] and len(spy[name]) == launches


def test_bf16_towers_keep_conv2d(spy):
    torch.manual_seed(0)
    bf16 = UAHN(dropout_rate=0.05, compute_dtype=torch.bfloat16, img_height=64,
                img_width=64).eval()
    img1, img2, prior, keys = _pair_call(bf16, 1)
    bf16(img1, img2, prior, use_prior=True, dropout_keys=keys)
    bf16(img1, img2, None, use_prior=False, dropout_keys=keys)
    assert spy == {"V1": [], "V2": [], "V2K": []}


@pytest.mark.parametrize("specs", [[(8, 7, 1), (16, 5, 2), (32, 3, 2)],
                                   [(64, 7, 2), (128, 5, 2), (256, 3, 2), (256, 3, 2)]],
                         ids=["V1", "V2"])
def test_tower_is_conv2d_on_the_cpu(specs):
    """Off the card a tower of either kernel's shapes is conv2d and
    leaky_relu, as before the kernels."""
    torch.manual_seed(0)
    tower = ConvTower(2, specs)
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


@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=SPLIT_IDS)
@pytest.mark.parametrize("b,h,w", [(64, None, None), (16, None, None), (13, None, None),
                                   (1, None, None), (3, 37, 53), (2, 5, 3), (2, 9, 11)],
                         ids=["B64", "B16", "B13", "B1", "3x37x53", "2x5x3", "2x9x11"])
def test_the_split_plain_version_is_the_whole_gemm(shape, b, h, w):
    """V2K's plain version (the shape's runs of c_in, each its own product,
    added to the bias in run order) against V2's single GEMM of the same
    layer, at the tower's size and at ragged ones: within
    ``rounding_bound``, and not the same function (the runs are split)."""
    h, w = (h, w) if h else LAYERS[shape][2]
    x, wt, bias = layer_inputs(shape, b, h, w, seed=b + 7 * SPLIT_SHAPES.index(shape))
    got = conv.V2K.plain(x, wt, bias, shape[3])
    assert got.equal(conv.conv_gemm_plain(x, wt, bias, shape[3], splits=SPLIT[shape]))
    whole = conv.conv_gemm_plain(x, wt, bias, shape[3], splits=1)
    assert within(got, whole, conv.rounding_bound(x, wt, bias, shape[3]))
    if b > 1:  # with many outputs, some round otherwise
        assert not got.equal(whole)


def kernel_order(x, wt, bias, stride, shape):
    """V2K's arithmetic op for op (each fma rounded once,
    ``ops/remap.fma_f32``): in each run of c_in, each group's k rows of
    every stage in k order from 0 (a run's rows past its end zeros), the
    groups added in order; then the bias plus the runs in run order, then
    the LeakyReLU."""
    from cuahn_vio_torch.ops.remap import fma_f32

    splits, (groups, rows) = SPLIT[shape], GROUPS[shape]
    c_out, c_in, k, _ = wt.shape
    b = x.shape[0]
    oh, ow = conv.out_size(x.shape[2], k, stride), conv.out_size(x.shape[3], k, stride)
    cols = F.unfold(x, k, padding=(k - 1) // 2, stride=stride).permute(1, 0, 2)  # (k, B, L)
    wk = wt.reshape(c_out, -1).T  # (k, c_out)
    runs = conv.split_runs(c_in, splits)
    stage = groups * rows
    span = -(-max(c1 - c0 for c0, c1 in runs) * k * k // stage) * stage
    idx = torch.tensor([[c0 * k * k + j if j < (c1 - c0) * k * k else -1 for j in range(span)]
                        for c0, c1 in runs], device=x.device)
    # (split, stage, group, row) -> (split, group, the group's rows in k order)
    idx = idx.reshape(splits, -1, groups, rows).transpose(1, 2).reshape(splits, groups, -1)
    a = torch.where(idx[..., None, None] >= 0, cols[idx.clamp(min=0)], 0.0)
    w_ = torch.where(idx[..., None] >= 0, wk[idx.clamp(min=0)], 0.0)
    acc = torch.zeros(splits, groups, b, c_out, cols.shape[-1], device=x.device)
    for j in range(idx.shape[-1]):
        acc = fma_f32(a[:, :, j, :, None, :], w_[:, :, j, None, :, None], acc)
    part = acc[:, 0]
    for g in range(1, groups):
        part = part + acc[:, g]
    out = bias[None, :, None] + part[0]
    for i in range(1, splits):
        out = out + part[i]
    out = torch.where(out > 0, out, out * torch.tensor(conv.LEAK, device=x.device))
    return out.reshape(b, c_out, oh, ow)


# ---------------------------------------------- V2's kernel, built for the host

HOST_SHIM = r"""
#include <ucontext.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <functional>
#include <type_traits>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __align__(n) alignas(n)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct Idx { unsigned x, y, z; };
static Idx blockIdx, threadIdx;
static float* host_smem;
static ucontext_t host_main, *host_self;
inline void __syncthreads() { swapcontext(host_self, &host_main); }
struct float4 { float x, y, z, w; };
struct int2 { int x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline int2 make_int2(int a, int b) { return {a, b}; }
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8, cudaDevAttrMultiProcessorCount = 16 };
static int host_sms = 1;  // the SMs the host build reports (host_set_sms)
inline int cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = host_sms; return cudaSuccess; }
extern "C" void host_set_sms(int sms) { host_sms = sms; }
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
template <class T> T __ldg(const T* p) { return *p; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
"""
# a block's threads as fibers of one host thread, each run in turn to its
# next __syncthreads, on shared memory filled with NaNs (a word read before
# it is written shows)
HOST_LAUNCH = r"""
static std::function<void()>* host_body;
static std::vector<char>* host_done;
static void host_fiber(int t) {
  (*host_body)();
  (*host_done)[t] = 1;
}
template <class F>
void host_launch(dim3 grid, unsigned threads, size_t smem_bytes, F kernel) {
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
        makecontext(&fibers[t], reinterpret_cast<void (*)()>(host_fiber), 1, static_cast<int>(t));
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
    """``conv_gemm.cu`` for the host: the shim for CUDA's few names, shared
    memory a buffer a block, the cp.async copies done at once, each launch
    (the GEMM's and the sum of the split path's) a call of ``host_launch``."""
    rewrites = [  # (regular expression, replacement)
        (re.escape("#include <cuda_runtime.h>"), HOST_SHIM.replace("\\", "\\\\")),
        (re.escape("extern __shared__ __align__(16) float smem[];"), "float* smem = host_smem;"),
        (r"__device__ __forceinline__ void copy4\(float\* dst, const float\* src, int bytes\) "
         r"\{.*?\n\}", "inline void copy4(float* dst, const float* src, int bytes) "
         "{ *dst = bytes ? *src : 0.0f; }"),
        (r"__device__ __forceinline__ void copies_commit\(\) \{.*?\}",
         "inline void copies_commit() {}"),
        (r"(template <int N>\n)__device__ __forceinline__ void copies_wait\(\) \{.*?\n\}",
         r"\1inline void copies_wait() {}"),
        (r"(template <int CIN, int COUT, int K, int S, bool N>\nint allow_smem\(\))",
         HOST_LAUNCH + r"\1"),
    ]
    for pattern, repl in rewrites:
        src, n = re.subn(pattern, repl, src, flags=re.S)
        assert n == 1, f"conv_gemm.cu is not as the host build expects: {pattern[:48]}"
    launch = (r"(\w+<[^<>]*>)<<<([^,]+), ([^,]+), ([^,]+),\s*static_cast<cudaStream_t>"
              r"\(stream\)>>>\((.*?)\);")
    src, n = re.subn(launch, r"host_launch(\2, \3, \4, [&] { \1(\5); });", src, flags=re.S)
    assert n == 2, "conv_gemm.cu is not as the host build expects: its two launches"
    return src


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel's source for the host")
    tmp = tmp_path_factory.mktemp("conv_gemm_host")
    with open(conv.V2.source) as f:
        (tmp / "conv_gemm_host.cpp").write_text(host_source(f.read()))
    lib = tmp / "libconv_gemm_host.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-o",
                    str(lib), str(tmp / "conv_gemm_host.cpp")],
                   check=True, timeout=300)
    host = ctypes.CDLL(str(lib))
    host.conv_gemm_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    host.conv_gemm_split_f32.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                                         + [ctypes.c_void_p])
    host.conv_gemm_f32.restype = host.conv_gemm_split_f32.restype = ctypes.c_int
    host.conv_gemm_splits.argtypes = [ctypes.c_int] * 4
    host.host_set_sms.argtypes = [ctypes.c_int]
    return host


def _host_run(host, x, wt, bias, stride):
    """The shape's launch of the host build: ``conv_gemm_split_f32`` with a
    workspace (NaNs, each read before its write shows) on the split path,
    ``conv_gemm_f32`` elsewhere."""
    c_out, c_in, k, _ = wt.shape
    b, _, h, w = x.shape
    oh, ow = conv.out_size(h, k, stride), conv.out_size(w, k, stride)
    out = torch.full((b, c_out, oh, ow), float("nan"))
    args = (b, c_in, c_out, k, stride, h, w, oh, ow, None)
    if (c_in, c_out, k, stride) in SPLIT:
        ws = torch.full((SPLIT[(c_in, c_out, k, stride)], c_out, -(-b * oh * ow // 4) * 4),
                        float("nan"))
        err = host.conv_gemm_split_f32(x.data_ptr(), wt.data_ptr(), bias.data_ptr(),
                                       out.data_ptr(), ws.data_ptr(), *args)
    else:
        err = host.conv_gemm_f32(x.data_ptr(), wt.data_ptr(), bias.data_ptr(), out.data_ptr(),
                                 *args)
    assert err == 0
    return out


@pytest.mark.parametrize("shape", V2_SHAPES, ids=[f"V2-{LAYERS[s][1]}" for s in V2_SHAPES])
def test_kernel_on_the_host_is_the_plain_version(host_kernel, shape):
    """Every tile and K-split of the shape's wide tiling (a card of one SM)
    and of its narrow one (a card of more SMs than any grid has blocks),
    planes whose size is and is not a multiple of 4 (float4 and single
    stores), a last tile part full; the two tilings the same bits, and row 1
    of a batch the same bits as that pair alone."""
    host_kernel.host_set_sms(1)
    for b, h, w in ((3, 14, 20), (2, 9, 5)):
        x, wt, bias = layer_inputs(shape, b, h, w, seed=V2_SHAPES.index(shape) + h)
        got = _host_run(host_kernel, x, wt, bias, shape[3])
        assert torch.isfinite(got).all()
        want = kernel_of(shape).plain(x, wt, bias, shape[3])
        assert within(got, want, conv.rounding_bound(x, wt, bias, shape[3]))
        if shape in SPLIT:  # the split path: its arithmetic op for op, bit for bit
            assert got.equal(kernel_order(x, wt, bias, shape[3], shape))
    assert _host_run(host_kernel, x[1:2].contiguous(), wt, bias, shape[3]).equal(got[1:2])
    try:
        host_kernel.host_set_sms(1 << 20)
        assert _host_run(host_kernel, x, wt, bias, shape[3]).equal(got)
    finally:
        host_kernel.host_set_sms(1)


def test_kernel_on_the_host_refuses_what_it_does_not_take(host_kernel):
    x, wt, bias = layer_inputs((16, 32, 3, 2), 1, 8, 8, seed=2)
    out = torch.empty(1, 32, 4, 4)
    args = (x.data_ptr(), wt.data_ptr(), bias.data_ptr(), out.data_ptr(), 1)
    invalid = 1  # the shim's cudaErrorInvalidValue
    assert host_kernel.conv_gemm_f32(*args, 16, 32, 3, 1, 8, 8, 4, 4, None) == invalid  # stride
    assert host_kernel.conv_gemm_f32(*args, 16, 32, 3, 2, 8, 8, 5, 4, None) == invalid  # oh
    assert host_kernel.conv_gemm_f32(*args, 2, 8, 7, 1, 8, 8, 8, 8, None) == invalid  # V1's


def test_the_split_path_takes_its_shapes_alone(host_kernel):
    """The library splits each of V2K's shapes as ``conv.V2K.splits`` says
    and no other; its whole-K launcher refuses V2K's shapes, the split
    launcher every other shape and a missing workspace."""
    assert conv.V2K.splits == SPLIT and not conv.V1.splits and not conv.V2.splits
    for shape in SHAPES + OTHERS:
        assert host_kernel.conv_gemm_splits(*shape) == SPLIT.get(shape, 0)
    invalid = 1  # the shim's cudaErrorInvalidValue
    for shape in V2_SHAPES:
        x, wt, bias = layer_inputs(shape, 1, 8, 8, seed=3)
        out = torch.empty(1, shape[1], 4, 4)
        ws = torch.empty(8, *out.shape)
        sizes = (1, *shape, 8, 8, 4, 4, None)
        ptrs = (x.data_ptr(), wt.data_ptr(), bias.data_ptr(), out.data_ptr())
        if shape in SPLIT:
            assert host_kernel.conv_gemm_f32(*ptrs, *sizes) == invalid
            assert host_kernel.conv_gemm_split_f32(*ptrs, None, *sizes) == invalid
        else:
            assert host_kernel.conv_gemm_split_f32(*ptrs, ws.data_ptr(), *sizes) == invalid


# ------------------------------------------------------------------ the card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: V1 and V2 are CUDA kernels with no CPU mode")
    from cuahn_vio_torch.ops.homography import f32_parity_mode

    f32_parity_mode()
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("b", [64, 16, 8, 1, 13])
def test_kernel_is_its_plain_version(card, shape, b):
    kernel = kernel_of(shape)
    h, w = LAYERS[shape][2]
    x, wt, bias = layer_inputs(shape, b, h, w, seed=b, device=card)
    before = dict(tcuda.launch_counts)
    got = conv.conv_leaky(x, wt, bias, shape[3])
    assert tcuda.launch_counts[kernel.name] == before[kernel.name] + 1
    split = conv.SPLIT_LAUNCHES if shape in SPLIT else 0
    assert tcuda.launch_counts[conv.SPLIT_NAME] == before[conv.SPLIT_NAME] + split
    want = kernel.plain(x, wt, bias, shape[3])
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert within(got, want, conv.rounding_bound(x, wt, bias, shape[3]))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("b,h,w", [(3, 37, 53), (2, 5, 3), (2, 9, 11), (1, 225, 321)])
def test_kernel_at_ragged_sizes(card, shape, b, h, w):
    x, wt, bias = layer_inputs(shape, b, h, w, seed=h, device=card)
    got = conv.conv_leaky_cuda(x, wt, bias, shape[3])
    want = kernel_of(shape).plain(x, wt, bias, shape[3])
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert within(got, want, conv.rounding_bound(x, wt, bias, shape[3]))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_a_pair_is_the_same_bits_at_any_batch(card, shape):
    h, w = LAYERS[shape][2]
    x, wt, bias = layer_inputs(shape, 64, h, w, seed=7, device=card)
    full = conv.conv_leaky_cuda(x, wt, bias, shape[3])
    for i in (0, 37, 63):
        assert conv.conv_leaky_cuda(x[i:i + 1].contiguous(), wt, bias, shape[3]).equal(
            full[i:i + 1])
    for lo, hi in ((8, 24), (40, 59)):  # B = 16 and 19
        assert conv.conv_leaky_cuda(x[lo:hi].contiguous(), wt, bias, shape[3]).equal(
            full[lo:hi])


@pytest.fixture(scope="module")
def model(card):
    from cuahn_vio_torch.models.uahn import build_uahn
    from cuahn_vio_torch.utils.checkpoint import load_params

    weights = os.path.join(os.path.dirname(__file__), "..", "weights", "uahn_fil_v10.msgpack")
    return build_uahn(load_params(weights), device=card)


def _pairs(b, seed, device):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (b, 232, 328)).astype(np.uint8)
    img1 = torch.as_tensor(base[:, 4:228, 4:324].copy(), device=device)
    img2 = torch.as_tensor(base[:, 2:226, 3:323].copy(), device=device)
    prior = torch.as_tensor(rng.normal(0.0, 2.0, (b, 4, 2)).astype(np.float32), device=device)
    keys = np.stack([np.array([seed, i], np.uint32) for i in range(b)])
    return img1, img2, prior, keys


# each kernel's launch_counts key: V2K's counts the split path's two
# launches a layer (V2's counts one a layer, the split path's too)
COUNTED = {"V1": conv.V1.name, "V2": conv.V2.name, "V2K": conv.SPLIT_NAME}


@pytest.mark.cuda
@pytest.mark.parametrize("name,launches", [("V1", 3), ("V2", 14), ("V2K", 12)],
                         ids=["V1-3", "V2-14", "V2K-12"])
def test_a_replay_is_the_eager_call_with_its_launches(model, name, launches):
    from cuahn_vio_torch.models import uahn_graphs

    net = copy.deepcopy(model)
    net._graphs = uahn_graphs.GraphCache()
    img1, img2, prior, keys = _pairs(16, 5, model.block2.conv0.weight.device)
    outs, moved = [], []
    for _ in range(3):  # eager, captured, replayed
        before = tcuda.launch_counts[COUNTED[name]]
        outs.append(net(img1, img2, prior, use_prior=True, dropout_keys=keys))
        moved.append(tcuda.launch_counts[COUNTED[name]] - before)
    torch.cuda.synchronize()
    assert len(net._graphs.captured()) == 1
    assert moved == [launches] * 3
    for out in outs[1:]:
        assert out[0].equal(outs[0][0]) and out[1].equal(outs[0][1])


@pytest.mark.cuda
@pytest.mark.parametrize("tower,layer", [("block4", "conv0"), ("block2", "conv1")],
                         ids=["V1", "V2"])
def test_a_weight_changed_in_place_is_read_at_the_next_replay(model, tower, layer):
    from cuahn_vio_torch.models import uahn_graphs

    net = copy.deepcopy(model)
    net._graphs = uahn_graphs.GraphCache()
    img1, img2, prior, keys = _pairs(8, 6, model.block2.conv0.weight.device)
    call = lambda: net(img1, img2, prior, use_prior=True, dropout_keys=keys)  # noqa: E731
    call(), call()
    before = call()
    with torch.no_grad():
        getattr(getattr(net, tower), layer).weight.mul_(1.25)  # in place: the same graphs
    after = call()
    assert net._graphs.captured() and len(net._graphs.captured()) == 1
    fresh = copy.deepcopy(net)
    fresh._graphs = uahn_graphs.GraphCache()
    want = fresh(img1, img2, prior, use_prior=True, dropout_keys=keys)  # eager
    assert not after[0].equal(before[0])
    assert after[0].equal(want[0]) and after[1].equal(want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(KERNELS))
def test_kernel_refuses_what_it_does_not_take(card, name):
    shape = OWN_AND_OTHER[name][0]
    s = shape[3]
    x, wt, bias = layer_inputs(shape, 2, 16, 20, seed=3, device=card)
    with pytest.raises(ValueError):
        conv.conv_leaky_cuda(x[..., ::2], wt, bias, s)  # not contiguous
    with pytest.raises(ValueError):
        conv.conv_leaky_cuda(x.half(), wt.half(), bias.half(), s)
    with pytest.raises(ValueError):
        conv.conv_leaky_cuda(x.cpu(), wt, bias, s)
    with pytest.raises(ValueError):
        conv.conv_leaky_cuda(x, wt, bias, 3 - s)  # the shape's stride is the other one


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=SPLIT_IDS)
@pytest.mark.parametrize("b", [64, 19, 16, 1])
def test_the_split_path_is_its_arithmetic_on_the_card(card, shape, b):
    """V2K on the card, wide tiling (B = 64, 19) or narrow (16, 1): bit for
    bit its arithmetic done op for op (``kernel_order``)."""
    h, w = LAYERS[shape][2]
    x, wt, bias = layer_inputs(shape, b, h, w, seed=b + 1, device=card)
    got = conv.conv_leaky_cuda(x, wt, bias, shape[3])
    assert got.equal(kernel_order(x, wt, bias, shape[3], shape))


@pytest.mark.cuda
def test_the_split_path_counts_nothing_under_autograd_or_in_bf16(model):
    """The split path's counter moves only where V2K runs: not while
    autograd records, not in the bf16 towers."""
    from cuahn_vio_torch.models.uahn import build_uahn

    img1, img2, prior, keys = _pairs(4, 8, model.block2.conv0.weight.device)
    before = tcuda.launch_counts[conv.SPLIT_NAME]
    with torch.enable_grad():
        model.flow_and_cov(img1, img2, prior, True, keys)
    # blocks 2 and 3 refine without autograd: two split layers each; block 4
    # records autograd, so its two go to conv2d
    assert tcuda.launch_counts[conv.SPLIT_NAME] == before + conv.SPLIT_LAUNCHES * 4
    before = tcuda.launch_counts[conv.SPLIT_NAME]
    bf16 = build_uahn(model.state_dict(), device=img1.device, compute_dtype=torch.bfloat16)
    with torch.no_grad():
        bf16(img1, img2, prior, use_prior=True, dropout_keys=keys)
    assert tcuda.launch_counts[conv.SPLIT_NAME] == before
