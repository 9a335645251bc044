"""A small msgpack encoder for what ``flax.serialization`` writes.

The inverse of ``msgpack_reader``: nested maps with str keys, and numpy
arrays as ext type 1 holding a packed (shape, dtype name, raw C-order
bytes) tuple, each value in the shortest form the msgpack spec allows (as
the ``msgpack`` package packs it), so Flax's ``from_bytes`` and
``msgpack_restore`` read the result.
"""

from __future__ import annotations

import struct

import numpy as np

from cuahn_vio_torch.utils.msgpack_reader import EXT_NDARRAY


def _sized(out: bytearray, n: int, fix: tuple[int, int] | None, codes: tuple[int, ...]) -> None:
    """A header for a length ``n``: the fix form (base, limit) when it
    fits, else the first of the 8-, 16- and 32-bit codes that does (a
    missing code is None)."""
    if fix is not None and n < fix[1]:
        out.append(fix[0] | n)
        return
    for code, fmt in zip(codes, (">B", ">H", ">I")):
        if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} too large for msgpack")


def _pack(obj, out: bytearray) -> None:
    if isinstance(obj, dict):
        _sized(out, len(obj), (0x80, 16), (None, 0xDE, 0xDF))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"map keys must be str, got {type(k).__name__}")
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _sized(out, len(obj), (0x90, 16), (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _sized(out, len(data), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, bytes):
        _sized(out, len(obj), None, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, int) and not isinstance(obj, bool) and obj >= 0:
        if obj < 0x80:
            out.append(obj)
            return
        for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")):
            if obj < 1 << (8 * struct.calcsize(fmt)):
                out.append(code)
                out += struct.pack(fmt, obj)
                return
        raise ValueError(f"int {obj} too large for msgpack")
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject or obj.dtype.names is not None:
            raise TypeError(f"cannot pack a {obj.dtype} array")
        payload = packb((list(obj.shape), obj.dtype.name, obj.tobytes("C")))
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(fixext[n])
        else:
            _sized(out, n, None, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", EXT_NDARRAY)
        out += payload
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    """Encode ``obj`` (nested dicts with str keys, lists, tuples, str,
    bytes, non-negative ints and numpy arrays: what a parameter tree
    holds) as msgpack."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)
