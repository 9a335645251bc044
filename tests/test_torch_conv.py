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
    got = KERNELS[LAYERS[shape][0]].plain(x, wt, bias, shape[3])
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
    assert conv.SHAPES[shape] is KERNELS[LAYERS[shape][0]]
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
    calls = {name: [] for name in KERNELS}
    takes, conv_leaky = conv.takes, conv.conv_leaky

    def takes_as_on_card(device, dtype, layer):
        return takes(CARD if device.type == "cpu" else device, dtype, layer)

    def recording(x, w, b, stride):
        shape = (w.shape[1], w.shape[0], w.shape[2], stride)
        calls[conv.SHAPES[shape].label].append(shape)
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


@pytest.mark.parametrize("name,launches", [("V1", 3), ("V2", 14)], ids=["V1-3", "V2-14"])
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


@pytest.mark.parametrize("name,launches", [("V1", 3), ("V2", 15)], ids=["V1-3", "V2-15"])
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
    assert spy == {"V1": [], "V2": []}


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
template <int CIN, int COUT, int K, int S, bool N, class... A>
void host_launch(dim3 grid, unsigned threads, size_t smem_bytes, A... args) {
  std::function<void()> body = [&] { gemm_conv_kernel<CIN, COUT, K, S, N>(args...); };
  std::vector<ucontext_t> fibers(threads);
  std::vector<std::vector<char>> stacks(threads, std::vector<char>(1 << 16));
  std::vector<char> done(threads);
  host_body = &body;
  host_done = &done;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::vector<float> smem(smem_bytes / 4, NAN);
      host_smem = smem.data();
      blockIdx = {bx, by, 0};
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
    memory a buffer a block, the cp.async copies done at once, the launch a
    call of ``host_launch``."""
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
        (r"gemm_conv_kernel<CIN, COUT, K, S, N><<<grid, G::kThreads, G::kSmemBytes,\s*"
         r"static_cast<cudaStream_t>\(stream\)>>>\(",
         "host_launch<CIN, COUT, K, S, N>(grid, G::kThreads, G::kSmemBytes, "),
        (r"(template <int CIN, int COUT, int K, int S, bool N>\nint allow_smem\(\))",
         HOST_LAUNCH + r"\1"),
    ]
    for pattern, repl in rewrites:
        src, n = re.subn(pattern, repl, src, flags=re.S)
        assert n == 1, f"conv_gemm.cu is not as the host build expects: {pattern[:48]}"
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
    host.conv_gemm_f32.restype = ctypes.c_int
    host.host_set_sms.argtypes = [ctypes.c_int]
    return host


def _host_run(host, x, wt, bias, stride):
    c_out, c_in, k, _ = wt.shape
    b, _, h, w = x.shape
    oh, ow = conv.out_size(h, k, stride), conv.out_size(w, k, stride)
    out = torch.full((b, c_out, oh, ow), float("nan"))
    err = host.conv_gemm_f32(x.data_ptr(), wt.data_ptr(), bias.data_ptr(), out.data_ptr(), b,
                             c_in, c_out, k, stride, h, w, oh, ow, None)
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
        want = conv.V2.plain(x, wt, bias, shape[3])
        assert within(got, want, conv.rounding_bound(x, wt, bias, shape[3]))
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
    kernel = KERNELS[LAYERS[shape][0]]
    h, w = LAYERS[shape][2]
    x, wt, bias = layer_inputs(shape, b, h, w, seed=b, device=card)
    before = tcuda.launch_counts[kernel.name]
    got = conv.conv_leaky(x, wt, bias, shape[3])
    assert tcuda.launch_counts[kernel.name] == before + 1
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
    want = KERNELS[LAYERS[shape][0]].plain(x, wt, bias, shape[3])
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
    assert conv.conv_leaky_cuda(x[8:24].contiguous(), wt, bias, shape[3]).equal(full[8:24])


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


@pytest.mark.cuda
@pytest.mark.parametrize("name,launches", [("V1", 3), ("V2", 14)], ids=["V1-3", "V2-14"])
def test_a_replay_is_the_eager_call_with_its_launches(model, name, launches):
    from cuahn_vio_torch.models import uahn_graphs

    net = copy.deepcopy(model)
    net._graphs = uahn_graphs.GraphCache()
    img1, img2, prior, keys = _pairs(16, 5, model.block2.conv0.weight.device)
    outs, moved = [], []
    for _ in range(3):  # eager, captured, replayed
        before = tcuda.launch_counts[KERNELS[name].name]
        outs.append(net(img1, img2, prior, use_prior=True, dropout_keys=keys))
        moved.append(tcuda.launch_counts[KERNELS[name].name] - before)
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
