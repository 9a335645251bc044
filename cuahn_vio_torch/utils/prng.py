"""The JAX random stream: threefry2x32 keys, ``jax.random``'s samplers and
Flax's rng folding, so that the port draws what the JAX package draws at a
seed.

JAX's default PRNG is a counter-based hash, Threefry-2x32 (Salmon et al.,
"Parallel random numbers: as easy as 1, 2, 3", 2011), and every draw of
the JAX package is a pure function of a key, a shape and a counter. This
module follows the semantics of ``jax_threefry_partitionable = True``
(JAX's default since 0.5), of ``jax_enable_x64 = False`` (the JAX
package's setting: a seed is taken to 32 bits) and of Flax's
``flax_fix_rng_separator = False`` (Flax's default).

Host side (numpy; a key is a (2,) uint32 array, made without touching the
device):

- ``prng_key(seed)``: ``jax.random.PRNGKey`` (``jax/_src/prng.py``
  ``threefry_seed``): the words (hi, lo) of the seed, hi = 0 for the
  32-bit seed that JAX without x64 takes.
- ``threefry2x32(key, x0, x1)``: 5 x 4 rounds of add, rotate (13, 15, 26,
  6 and 17, 29, 16, 24) and xor, the key schedule (k0, k1, k0 ^ k1 ^
  0x1BD11BDA) injected after every 4 rounds with the round count
  (``_threefry2x32_lowering``).
- ``split(key, n)``: key i = threefry(key, (hi(i), lo(i))), so
  ``split(key, n)`` is a prefix of ``split(key, n + 1)``
  (``_threefry_split_foldlike``).
- ``fold_in(key, d)``: threefry(key, (0, d)) (``threefry_fold_in``).
- ``flax_fold(key, *data)``: Flax's ``_fold_in_static``
  (``flax/core/scope.py``): the SHA-1 of the strings (UTF-8) and ints (big
  endian, shortest) in order, its first 4 bytes big endian folded in.
- ``dropout_key(key, head, idx)``: the key Flax's ``make_rng("dropout")``
  gives the ``Dropout_<idx>`` of ``UAHN/<head>`` at its first call, under
  ``model.apply(..., rngs={"dropout": key})``: the path below the root and
  the counter 1 folded in (``scope.push``, ``Scope.make_rng``).

Device side (torch; K keys as a (K, 2) int32 tensor holding the uint32
words, ``keys_tensor``): ``draw`` fills one flat row per key with
``counts[i]`` values, rows concatenated in key order, and the samplers
shape them (one shape for every key, or one shape each):

- ``random_bits``: for flat index j of row i, x0 ^ x1 of threefry(key_i,
  (hi(j), lo(j))) (``_threefry_random_bits_partitionable``), as int32.
- ``uniform(lo, hi)``: ``((bits >> 9) | 0x3F800000)`` as float32 minus 1,
  times (hi - lo) plus lo in one fused multiply-add, then ``max(lo, .)``
  (``jax.random.uniform``; XLA's CPU backend contracts the two).
- ``bernoulli(p)``: uniform on [0, 1) < float32(p), as uint8
  (``jax.random.bernoulli``, mode "low").
- ``normal``: sqrt(2) erf_inv(u), u uniform on (nextafter(-1, 0), 1)
  (``jax.random.normal``), with XLA's float32 ``erf_inv``: w =
  -log1p(-u u), then one of Giles' two 9-term polynomials, split at w < 5
  ("Approximating the erfinv function", 2010), by Horner's rule in fused
  multiply-adds.
- ``truncated_normal(lower, upper)``: sqrt(2) erf_inv(u), u uniform on
  [erf(lower / sqrt2), erf(upper / sqrt2)) (uniform's fma), clipped to
  (nextafter(lower, +inf), nextafter(upper, -inf))
  (``jax.random.truncated_normal``; the two erf values are float32's
  correctly rounded ones, which XLA's erf gives at the initializers'
  +-2).
- ``randint(lo, hi)``: of the two keys of ``split(key)``, 32 random bits
  each (hi, lo words), then ``lo + ((hi % span) * m + lo % span) % span``
  in uint32 arithmetic that wraps, span = hi - lo (1 where hi <= lo), m =
  (2^16 % span)^2 % span (``jax.random.randint`` for int32; the integer
  work is a few values a draw, in torch on the bits of one T1 launch).

On a CUDA tensor of keys the samplers launch the hand-written kernel T1
(``ops/cuda/prng.cu``), one launch for all K rows; on a CPU tensor they
take ``draw_plain``, the same arithmetic in torch int64 masked to 32 bits.
bits, uniform, bernoulli and randint equal ``jax.random``'s bit for bit;
normal and truncated normal are within 5e-7 (99 % of values bit-equal),
since XLA's CPU ``log1p`` is its own polynomial. ``draw_fields`` draws
several fields of one mode, each from its own host keys at its own shape,
in one launch (one copy of their keys to the device).
"""

from __future__ import annotations

import hashlib
import math
from typing import Sequence

import numpy as np
import torch

from cuahn_vio_torch.ops.remap import fma_f32

MASK32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA
# the draw modes of ``draw`` and of kernel T1
BITS, UNIFORM, BERNOULLI, NORMAL, TRUNC_NORMAL = 0, 1, 2, 3, 4
MODE_NAMES = ("bits", "uniform", "bernoulli", "normal", "truncated_normal")
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2_F32 = float(np.float32(math.sqrt(2.0)))
# XLA's float32 erf_inv (ErfInv32): p(w) coefficients, highest power first,
# for w = -log1p(-x^2) < 5 (in w - 2.5) and otherwise (in sqrt(w) - 3)
ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
              0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
              0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


# ---------------------------------------------------------------- host side

def _rotl_np(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the counter words (x0, x1) (uint32 arrays) under
    ``key`` (..., 2) uint32, broadcast against the counters -> the two
    output words."""
    key = np.asarray(key, np.uint32)
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(KS_PARITY))
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl_np(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` without x64: the seed taken to 32 bits
    (two's complement), so the high word is 0."""
    return np.array([0, int(seed) & MASK32], np.uint32)


def split(key, n: int = 2) -> np.ndarray:
    """``jax.random.split(key, n)`` -> (n, 2) uint32; of each key of (...,
    2) -> (..., n, 2)."""
    key = np.asarray(key, np.uint32)[..., None, :]
    i = np.arange(n, dtype=np.uint64)
    y0, y1 = threefry2x32(key, (i >> np.uint64(32)).astype(np.uint32),
                          (i & np.uint64(MASK32)).astype(np.uint32))
    return np.stack([y0, y1], axis=-1)


def fold_in(key, data) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` (data taken to 32 bits) of a (2,)
    key or of each key of (..., 2), and of an int or each int of an array
    (key and data broadcast) -> (..., 2) uint32."""
    key = np.asarray(key, np.uint32)
    d = (np.asarray(data, np.int64) & MASK32).astype(np.uint32)
    y0, y1 = threefry2x32(key, np.zeros_like(d), d)
    return np.stack([y0, y1], axis=-1).astype(np.uint32)


def static_hash(*data) -> int:
    """The 32-bit word that Flax's ``_fold_in_static`` folds in for
    ``data``: the SHA-1 of the strings (UTF-8) and non-negative ints (big
    endian, shortest) in order, no separator, its first 4 bytes big
    endian."""
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"expected an int or a string, got {x!r}")
    return int.from_bytes(m.digest()[:4], byteorder="big")


def flax_fold(key, *data) -> np.ndarray:
    """Flax's ``_fold_in_static(key, data)``: ``static_hash(*data)`` folded
    into the key (or each key of (..., 2)); no data returns the key."""
    if not data:
        return np.asarray(key, np.uint32)
    return fold_in(key, static_hash(*data))


def dropout_key(key, head: str, idx: int) -> np.ndarray:
    """The mask key of ``UAHN/<head>/Dropout_<idx>`` (the first
    ``make_rng("dropout")`` of that module) under ``rngs={"dropout": key}``."""
    return flax_fold(key, head, f"Dropout_{idx}", 1)


# the UAHN's four MC-dropout masks, in the order a network call draws them:
# (head, Dropout index); Dropout_0 masks the (16, fc input) features,
# Dropout_1 the (16, 256) hidden layer
MASK_SITES = (("head_mean", 0), ("head_mean", 1), ("head_logvar", 0), ("head_logvar", 1))
_SITE_HASHES = tuple(static_hash(head, f"Dropout_{idx}", 1) for head, idx in MASK_SITES)


def mask_keys(keys) -> np.ndarray:
    """(..., 2) uint32 network-call keys (``rngs={"dropout": key}``) ->
    (..., 4, 2): the keys of the call's four masks, in ``MASK_SITES``
    order."""
    keys = np.asarray(keys, np.uint32)
    return np.stack([fold_in(keys, h) for h in _SITE_HASHES], axis=-2)


def keys_tensor(keys, device="cpu") -> torch.Tensor:
    """(..., 2) uint32 keys -> an int32 tensor of the same words on
    ``device``; to a GPU through pinned memory, without waiting for the
    device (the host goes on queueing work)."""
    arr = np.ascontiguousarray(np.asarray(keys, np.uint32)).view(np.int32)
    host = torch.from_numpy(arr.copy())
    if torch.device(device).type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def truncation_bounds(lower: float, upper: float) -> tuple[float, float, float, float]:
    """``truncated_normal``'s float32 constants of (lower, upper): the
    uniform's bounds erf(lower / sqrt2), erf(upper / sqrt2) (float32's
    correctly rounded erf of the float32 quotient) and the clip bounds
    nextafter(lower, +inf), nextafter(upper, -inf)."""
    lo, hi, s2 = np.float32(lower), np.float32(upper), np.float32(SQRT2_F32)
    erf = [float(np.float32(math.erf(float(x / s2)))) for x in (lo, hi)]
    return (erf[0], erf[1], float(np.nextafter(lo, np.float32(np.inf))),
            float(np.nextafter(hi, np.float32(-np.inf))))


def bernoulli_threshold(p: float) -> int:
    """The integer T with ``(bits >> 9) < T`` exactly when
    ``jax.random.bernoulli``'s coin ``unit float < float32(p)`` holds: the
    unit float of 32 bits is m 2^-23 exactly, m = bits >> 9 < 2^23, so T
    is ceil(float32(p) 2^23) (exact in float64): 0 for p <= 0 or NaN, and
    2^23, every coin, from float32(p) = 1 - 2^-24 up. Kernel T1 draws its
    Bernoulli values in runs with it."""
    p32 = float(np.float32(p))
    if not p32 > 0.0:
        return 0
    if p32 >= 1.0:
        return 2**23
    return math.ceil(p32 * 2.0**23)


# -------------------------------------------------------------- device side

def threefry2x32_plain(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                       x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 in int64 arithmetic masked to 32 bits; the key words
    broadcast against the counter words (all int64 holding uint32). The
    rounds run in place (a draw of millions of values is bound by
    allocating its temporaries)."""
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    a = (x0 + ks[0]).bitwise_and_(MASK32)
    b = (x1 + ks[1]).bitwise_and_(MASK32)
    high = torch.empty_like(b)
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            a.add_(b).bitwise_and_(MASK32)
            torch.bitwise_left_shift(b, r, out=high)  # b rotated left by r, xor a
            b.bitwise_right_shift_(32 - r).bitwise_or_(high).bitwise_and_(MASK32).bitwise_xor_(a)
        a.add_(ks[(i + 1) % 3]).bitwise_and_(MASK32)
        b.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(MASK32)
    return a, b


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 -> the float32 with those bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32).view(torch.float32)


def erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv, op for op, each Horner step one fused
    multiply-add (XLA's CPU backend contracts them)."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    lt5, ge5 = (torch.tensor(c, dtype=torch.float32, device=x.device)
                for c in (ERFINV_LT5, ERFINV_GE5))
    p = torch.where(lt, lt5[0], ge5[0])
    for i in range(1, len(ERFINV_LT5)):
        p = fma_f32(p, w, torch.where(lt, lt5[i], ge5[i]))
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max, p * x)


def uniform_from_bits(bits: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jax.random.uniform``'s float32 of 32 random bits (int64 holding
    uint32) on [lo, hi); ``floats * (hi - lo) + lo`` is one fused
    multiply-add, as XLA's CPU backend contracts it."""
    lo_t = torch.tensor(lo, dtype=torch.float32, device=bits.device)
    scale = torch.tensor(hi, dtype=torch.float32, device=bits.device) - lo_t
    floats = _f32_bits((bits >> 9) | 0x3F800000) - 1.0
    return torch.maximum(lo_t, fma_f32(floats, scale.expand_as(floats), lo_t.expand_as(floats)))


def draw_plain(keys: torch.Tensor, counts: Sequence[int], mode: int,
               a: float = 0.0, b: float = 1.0) -> torch.Tensor:
    """Kernel T1's plain version: the flat rows of ``counts[i]`` draws of
    each key of the (K, 2) int32 ``keys``, concatenated. ``mode``: BITS
    (int32), UNIFORM on [a, b) (float32), BERNOULLI with p = a (uint8),
    NORMAL (float32), TRUNC_NORMAL on (a, b) (float32)."""
    k = keys.to(torch.int64) & MASK32
    counts = [int(c) for c in counts]
    row = torch.repeat_interleave(torch.arange(len(counts), device=keys.device),
                                  torch.tensor(counts, device=keys.device))
    starts = torch.tensor([0, *np.cumsum(counts)[:-1]], dtype=torch.int64, device=keys.device)
    j = torch.arange(sum(counts), dtype=torch.int64, device=keys.device) - starts[row]
    y0, y1 = threefry2x32_plain(k[row, 0], k[row, 1], j >> 32, j & MASK32)
    bits = y0 ^ y1
    if mode == BITS:
        return (bits - ((bits >> 31) << 32)).to(torch.int32)
    if mode == UNIFORM:
        return uniform_from_bits(bits, a, b)
    if mode == BERNOULLI:
        return (uniform_from_bits(bits, 0.0, 1.0) < float(np.float32(a))).to(torch.uint8)
    if mode == NORMAL:
        return SQRT2_F32 * erf_inv_f32(uniform_from_bits(bits, NORMAL_LO, 1.0))
    if mode == TRUNC_NORMAL:
        u_lo, u_hi, clip_lo, clip_hi = truncation_bounds(a, b)
        out = SQRT2_F32 * erf_inv_f32(uniform_from_bits(bits, u_lo, u_hi))
        return torch.clamp(out, clip_lo, clip_hi)
    raise ValueError(f"unknown draw mode {mode}")


def draw(keys: torch.Tensor, counts: Sequence[int], mode: int,
         a: float = 0.0, b: float = 1.0) -> torch.Tensor:
    """``draw_plain``'s function; CUDA keys launch kernel T1 once (or
    raise), CPU keys take ``draw_plain``."""
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int32:
        raise ValueError(f"keys must be (K, 2) int32, got {tuple(keys.shape)} {keys.dtype}")
    if len(counts) != keys.shape[0]:
        raise ValueError(f"{len(counts)} counts for {keys.shape[0]} keys")
    if keys.is_cuda:
        from cuahn_vio_torch.ops.cuda.prng import draw_cuda

        return draw_cuda(keys, counts, mode, a, b)
    return draw_plain(keys, counts, mode, a, b)


def _sample(keys: torch.Tensor, shapes, mode: int, a: float = 0.0, b: float = 1.0):
    """``draw`` of each key at its shape: one shape (a tuple of ints) for
    every key gives a (K, *shape) tensor, a list of shapes a list of
    tensors (views of one buffer)."""
    if isinstance(shapes, tuple) and all(isinstance(d, int) for d in shapes):
        flat = draw(keys, [math.prod(shapes)] * keys.shape[0], mode, a, b)
        return flat.view(keys.shape[0], *shapes)
    shapes = [tuple(s) for s in shapes]
    sizes = [math.prod(s) for s in shapes]
    flat = draw(keys, sizes, mode, a, b)
    return [r.view(s) for r, s in zip(torch.split(flat, sizes), shapes)]


def random_bits(keys: torch.Tensor, shapes):
    """``jax.random.bits`` (uint32, as int32) of each key at its shape."""
    return _sample(keys, shapes, BITS)


def uniform(keys: torch.Tensor, shapes, lo: float = 0.0, hi: float = 1.0):
    """``jax.random.uniform(key, shape, minval=lo, maxval=hi)`` of each key."""
    return _sample(keys, shapes, UNIFORM, lo, hi)


def bernoulli(keys: torch.Tensor, shapes, p: float):
    """``jax.random.bernoulli(key, p, shape)`` of each key, as uint8."""
    return _sample(keys, shapes, BERNOULLI, p)


def normal(keys: torch.Tensor, shapes):
    """``jax.random.normal(key, shape)`` (float32) of each key."""
    return _sample(keys, shapes, NORMAL)


def truncated_normal(keys: torch.Tensor, shapes, lower: float, upper: float):
    """``jax.random.truncated_normal(key, lower, upper, shape)`` (float32)
    of each key."""
    return _sample(keys, shapes, TRUNC_NORMAL, lower, upper)


def _mul32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x * y mod 2^32 of int64 tensors holding uint32, without int64
    overflow (y in 16-bit halves)."""
    return (x * (y & 0xFFFF) + (((x * (y >> 16)) & 0xFFFF) << 16)) & MASK32


def randint(keys, shape: tuple, lo: int, hi: int, device="cpu") -> torch.Tensor:
    """``jax.random.randint(key, shape, lo, hi)`` (int32) of each of the
    host keys (..., 2) uint32 -> (..., *shape) int32 on ``device``: the
    bits of the keys' two halves of ``split(key)`` in one draw (one T1
    launch on a GPU), then the integer arithmetic."""
    keys = np.asarray(keys, np.uint32)
    lead = keys.shape[:-1]
    halves = np.moveaxis(split(keys.reshape(-1, 2), 2), 1, 0)  # (2, K, 2): k1s, then k2s
    n = math.prod(shape)
    k = halves.shape[1]
    bits = draw(keys_tensor(halves.reshape(-1, 2), device), [n] * (2 * k), BITS)
    bits = bits.view(2, k * n).to(torch.int64) & MASK32
    lo32, hi32 = int(lo) & MASK32, int(hi) & MASK32
    span = 1 if int(hi) <= int(lo) else (hi32 - lo32) & MASK32
    mult = ((2 ** 16 % span) ** 2 & MASK32) % span  # uint32 products wrap
    offset = (_mul32(bits[0] % span, torch.full_like(bits[0], mult)) + bits[1] % span) & MASK32
    out = (lo32 + offset % span) & MASK32
    return (out - ((out >> 31) << 32)).to(torch.int32).view(*lead, *shape)


def draw_field(keys, shape: tuple, mode: int, device, a: float = 0.0,
               b: float = 1.0) -> torch.Tensor:
    """One field of ``draw_fields``: (..., *shape) draws of the host keys
    (..., 2), one launch."""
    return draw_fields([(keys, shape)], mode, device, a, b)[0]


def draw_fields(fields, mode: int, device, a: float = 0.0, b: float = 1.0) -> list:
    """Several fields of one mode in one draw (one T1 launch on a GPU):
    field i is (host keys (..., 2) uint32, shape); its keys go to
    ``device`` in one copy with the others', and it comes back as a
    (..., *shape) tensor, each key's draw that of ``_sample``."""
    keys = [np.asarray(k, np.uint32) for k, _ in fields]
    counts, sizes = [], []
    for k, (_, shape) in zip(keys, fields):
        n = math.prod(k.shape[:-1])
        counts += [math.prod(shape)] * n
        sizes.append(n * math.prod(shape))
    table = keys_tensor(np.concatenate([k.reshape(-1, 2) for k in keys]), device)
    flat = draw(table, counts, mode, a, b)
    return [r.view(*k.shape[:-1], *shape)
            for r, k, (_, shape) in zip(torch.split(flat, sizes), keys, fields)]
