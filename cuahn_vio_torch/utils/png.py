"""PNG reader and writer for camera frames, with ``zlib`` and numpy only.

The port's stand-in for the ``PIL.Image`` calls of the JAX package's EuRoC
ingestion (``cuahn_vio/data/euroc.py``): the card's machine has no PIL.

- ``read_png`` / ``read_pngs``: 8-bit, non-interlaced PNGs, every row
  filter (None, Sub, Up, Average, Paeth; encoders choose one per row), as
  a (H, W) uint8 greyscale image. Greyscale is read as it is; grey+alpha,
  RGB and RGBA are converted as PIL's ``Image.convert("L")`` converts them:
  the alpha dropped, ``L = (R*19595 + G*38470 + B*7471 + 0x8000) >> 16``.
  With ``rgb=True``, as (H, W, 3) uint8, as PIL's ``convert("RGB")``: the
  alpha dropped, a grey level repeated.
  Palette, 16-bit (or fewer than 8 bits) and interlaced files are refused
  with an error that names the file and what it lacks.
- ``write_png``: 8-bit greyscale ((H, W) uint8) or RGB ((H, W, 3) uint8,
  colour type 2), filter None on every row.

Unfiltering is vectorised. Rows filtered None, Sub or Up depend on their
own row and the row above only through a running sum, so each is one
numpy operation (Sub a cumulative sum mod 256 along the row, Up a row
add). Average and Paeth predict a byte from its left, upper and
upper-left neighbours, so no row can be done before the one above it, nor
a byte before its left neighbour; but every byte of one anti-diagonal of
the image (row + column = d) depends only on the two diagonals before it.
An image with such rows is therefore unfiltered diagonal by diagonal, all
of a diagonal's bytes at once (all five filters there, chosen per row),
and ``read_pngs`` does that for all its same-shape images at once.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel
DIAGONAL_BATCH = 32  # images unfiltered together (~2 MB each at 640x480 grey)
ZLIB_LEVEL = 6  # PIL's default deflate level for PNG
_COLOUR = {0: "greyscale", 2: "RGB", 3: "palette", 4: "grey+alpha", 6: "RGBA"}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """The bytes of an 8-bit PNG of ``img``, greyscale for (H, W) uint8,
    RGB (colour type 2) for (H, W, 3) uint8, every row filtered None,
    deflated at ``ZLIB_LEVEL``."""
    img = np.asarray(img)
    rgb = img.ndim == 3 and img.shape[2] == 3
    if not (img.ndim == 2 or rgb) or img.dtype != np.uint8:
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8, got {img.shape} "
                         f"{img.dtype}")
    hgt, wid = img.shape[:2]
    raw = np.zeros((hgt, 1 + img[0].size), np.uint8)  # a leading 0 a row: filter None
    raw[:, 1:] = img.reshape(hgt, -1)
    header = struct.pack(">IIBBBBB", wid, hgt, 8, 2 if rgb else 0, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), ZLIB_LEVEL)) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _parse(data: bytes, name: str):
    """(height, width, colour type, (H, 1 + W x channels) filtered rows)."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{name}: truncated {kind!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"{name}: bad CRC in the {kind!r} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{name}: no IHDR or no IDAT chunk")
    wid, hgt, depth, colour, method, filter_method, interlace = header
    if colour == 3:
        raise ValueError(f"{name}: palette PNG (colour type 3); only 8-bit greyscale, "
                         "grey+alpha, RGB and RGBA are read")
    if colour not in _CHANNELS:
        raise ValueError(f"{name}: unknown colour type {colour}")
    if depth != 8:
        raise ValueError(f"{name}: {depth}-bit {_COLOUR[colour]} PNG; only 8 bits a sample "
                         "are read")
    if interlace:
        raise ValueError(f"{name}: interlaced (Adam7) PNG; only non-interlaced files are read")
    if method or filter_method:
        raise ValueError(f"{name}: unknown compression or filter method")
    stride = wid * _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != hgt * (stride + 1):
        raise ValueError(f"{name}: {raw.size} bytes of image data, expected "
                         f"{hgt * (stride + 1)}")
    return hgt, wid, colour, raw.reshape(hgt, stride + 1)


def _unfilter_rows(types: np.ndarray, rows: np.ndarray, bpp: int) -> np.ndarray:
    """One image whose rows are filtered None, Sub or Up only: row by row,
    each row one vector operation."""
    hgt, stride = rows.shape
    out = np.empty_like(rows)
    prev = np.zeros(stride, np.uint8)
    for r in range(hgt):
        if types[r] == 0:
            out[r] = rows[r]
        elif types[r] == 1:
            out[r] = np.cumsum(rows[r].reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        else:
            np.add(rows[r], prev, out=out[r])
        prev = out[r]
    return out


def _unfilter_diagonals(types: np.ndarray, rows: np.ndarray, bpp: int) -> np.ndarray:
    """B images of one shape with any filters: (B, H) row types, (B, H,
    stride) filtered bytes -> (B, H, stride) bytes, diagonal by diagonal.

    Pixel (r, x) sits at row i = r + 1, column j = x + 1 of a zero-padded
    image P, stored skewed with the diagonal first: S[i + j, :, i] =
    P[:, i, j]. Its left neighbour is then S[d - 1, :, i], its upper one
    S[d - 1, :, i - 1] and its upper-left one S[d - 2, :, i - 1] (d = i +
    j), so a diagonal of all B images is one contiguous slab of S and its
    neighbours are slices of the two slabs before."""
    nb, hgt, stride = rows.shape
    wid = stride // bpp
    skew = np.zeros((hgt + wid + 1, nb, hgt + 1, bpp), np.int16)
    filt = np.zeros_like(skew)
    i = np.arange(1, hgt + 1)[:, None]
    d = i + np.arange(1, wid + 1)[None, :]
    filt[d, :, i] = rows.reshape(nb, hgt, wid, bpp).transpose(1, 2, 0, 3)
    kind = [(types == k)[:, :, None].astype(np.int16) for k in range(5)]  # (B, H, 1)
    has_avg, has_paeth = bool(kind[3].any()), bool(kind[4].any())
    for col in range(2, hgt + wid + 1):
        lo, hi = max(1, col - wid), min(hgt, col - 1)  # the rows i of this diagonal
        a = skew[col - 1, :, lo:hi + 1]
        b = skew[col - 1, :, lo - 1:hi]
        k = [m[:, lo - 1:hi] for m in kind]
        pred = a * k[1] + b * k[2]
        if has_avg:
            pred += ((a + b) >> 1) * k[3]
        if has_paeth:
            c = skew[col - 2, :, lo - 1:hi]
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
            pred += paeth * k[4]
        skew[col, :, lo:hi + 1] = (filt[col, :, lo:hi + 1] + pred) & 255
    return skew[d, :, i].transpose(2, 0, 1, 3).astype(np.uint8).reshape(nb, hgt, stride)


def _to_grey(img: np.ndarray, colour: int) -> np.ndarray:
    """(..., H, W x channels) bytes -> (..., H, W) uint8, as PIL's
    ``convert("L")``."""
    ch = _CHANNELS[colour]
    px = img.reshape(*img.shape[:-1], -1, ch)
    if colour in (0, 4):
        return np.ascontiguousarray(px[..., 0])
    rgb = px[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def _to_rgb(img: np.ndarray, colour: int) -> np.ndarray:
    """(..., H, W x channels) bytes -> (..., H, W, 3) uint8, as PIL's
    ``convert("RGB")``."""
    px = img.reshape(*img.shape[:-1], -1, _CHANNELS[colour])
    if colour in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def decode_pngs(blobs: list, names: list | None = None, rgb: bool = False) -> list:
    """The (H, W) uint8 greyscale images of PNG file contents ``blobs``
    ((H, W, 3) RGB with ``rgb``); images of one shape and colour type with
    Average or Paeth rows are unfiltered together."""
    convert = _to_rgb if rgb else _to_grey
    names = names or [f"<png {k}>" for k in range(len(blobs))]
    parsed = [_parse(blob, name) for blob, name in zip(blobs, names)]
    out = [None] * len(parsed)
    groups = {}
    for k, (hgt, wid, colour, raw) in enumerate(parsed):
        types = raw[:, 0]
        if types.max(initial=0) > 4:
            raise ValueError(f"{names[k]}: unknown row filter {int(types.max())}")
        if types.max(initial=0) <= 2:
            out[k] = convert(_unfilter_rows(types, raw[:, 1:], _CHANNELS[colour]), colour)
        else:
            groups.setdefault((hgt, wid, colour), []).append(k)
    for (_, _, colour), members in groups.items():
        for start in range(0, len(members), DIAGONAL_BATCH):
            batch = members[start:start + DIAGONAL_BATCH]
            types = np.stack([parsed[k][3][:, 0] for k in batch])
            rows = np.stack([parsed[k][3][:, 1:] for k in batch])
            images = convert(_unfilter_diagonals(types, rows, _CHANNELS[colour]), colour)
            for k, img in zip(batch, images):
                out[k] = img
    return out


def read_pngs(paths: list, rgb: bool = False) -> list:
    """The (H, W) uint8 greyscale images of the PNG files ``paths``
    ((H, W, 3) RGB with ``rgb``)."""
    blobs = []
    for path in paths:
        with open(path, "rb") as f:
            blobs.append(f.read())
    return decode_pngs(blobs, list(paths), rgb)


def read_png(path: str, rgb: bool = False) -> np.ndarray:
    """The (H, W) uint8 greyscale image of one PNG file ((H, W, 3) RGB with
    ``rgb``)."""
    return read_pngs([path], rgb)[0]
