"""The JAX random stream as the benchmark needs it, with no program code.

A frozen copy of the arithmetic of ``cuahn_vio_torch/utils/prng.py``
(Threefry-2x32 under ``jax_threefry_partitionable``, ``split``,
``fold_in``, Flax's ``_fold_in_static``), of the UAHN's MC-dropout mask
keys (``prng.mask_keys``) and of ``jax.random.bernoulli``'s coin, so that
the plain reference draws the masks that the program's kernel T1 draws
from the same keys. Host keys are (..., 2) uint32 numpy arrays; the
device-side draw works in int64 masked to 32 bits.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA
# the UAHN's four dropout sites, in the order a network call draws them
MASK_SITES = (("head_mean", 0), ("head_mean", 1), ("head_logvar", 0), ("head_logvar", 1))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 of the counter words (x0, x1) under ``key`` (..., 2)."""
    key = np.asarray(key, np.uint32)
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(KS_PARITY))
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` without x64: the seed taken to 32 bits."""
    return np.array([0, int(seed) & MASK32], np.uint32)


def split(key, n: int = 2) -> np.ndarray:
    """``jax.random.split``: (..., 2) -> (..., n, 2)."""
    key = np.asarray(key, np.uint32)[..., None, :]
    i = np.arange(n, dtype=np.uint64)
    y0, y1 = threefry2x32(key, (i >> np.uint64(32)).astype(np.uint32),
                          (i & np.uint64(MASK32)).astype(np.uint32))
    return np.stack([y0, y1], axis=-1)


def fold_in(key, data) -> np.ndarray:
    """``jax.random.fold_in`` of a key (or keys) and an int (or ints)."""
    key = np.asarray(key, np.uint32)
    d = (np.asarray(data, np.int64) & MASK32).astype(np.uint32)
    y0, y1 = threefry2x32(key, np.zeros_like(d), d)
    return np.stack([y0, y1], axis=-1).astype(np.uint32)


def static_hash(*data) -> int:
    """Flax's ``_fold_in_static`` word: SHA-1 of the strings and ints, first
    4 bytes big endian."""
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, byteorder="big"))
    return int.from_bytes(m.digest()[:4], byteorder="big")


def mask_keys(call_keys) -> np.ndarray:
    """(..., 2) network-call keys -> (..., 4, 2): the keys of the call's
    four dropout masks, in ``MASK_SITES`` order (the first
    ``make_rng("dropout")`` of ``UAHN/<head>/Dropout_<idx>``)."""
    call_keys = np.asarray(call_keys, np.uint32)
    return np.stack([fold_in(call_keys, static_hash(h, f"Dropout_{i}", 1))
                     for h, i in MASK_SITES], axis=-2)


def _threefry_torch(k0, k1, x0, x1):
    """Threefry-2x32 on int64 tensors holding uint32 words."""
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    a = (x0 + ks[0]) & MASK32
    b = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            a = (a + b) & MASK32
            b = (((b << r) | (b >> (32 - r))) & MASK32) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return a, b


def bernoulli_rows(keys: torch.Tensor, n: int, p: float) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, (n,))`` of each key of the (K, 2)
    int64 tensor of uint32 words -> (K, n) bool: the unit float
    ``((bits >> 9) | 0x3F800000) - 1`` below float32(p), bits = x0 ^ x1
    of threefry(key, (0, j))."""
    k0, k1 = keys[:, 0:1], keys[:, 1:2]
    j = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    y0, y1 = _threefry_torch(k0, k1, j >> 32, j & MASK32)
    bits = (y0 ^ y1) >> 9
    unit = ((bits | 0x3F800000).to(torch.int32).view(torch.float32)) - 1.0
    return unit < float(np.float32(p))
