"""The port's PNG codec (``cuahn_vio_torch.utils.png``) against PIL, the
JAX package's codec (``cuahn_vio/data/euroc.py`` reads with
``Image.open(...).convert("L")`` and writes with ``Image.save``).

Exact in every case: the port writes and PIL reads the same pixels; PIL
writes L, LA, RGB and RGBA (its encoder picks None, Sub, Up or Paeth per
row) and the port reads what ``convert("L")`` gives; a file with rows of
all five filters, Average among them (which PIL's encoder never picks),
is filtered by hand here and read by both. Palette, 16-bit and interlaced
files are refused with the file named.
"""

import io
import struct
import zlib

import numpy as np
import pytest

from cuahn_vio_torch.utils import png

Image = pytest.importorskip("PIL.Image")

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def _content(rng, h: int, w: int, ch: int) -> np.ndarray:
    """Noise, gradients and flat runs, so that the encoder's per-row choice
    varies."""
    img = rng.integers(0, 256, (h, w, ch)).astype(np.uint8)
    ramp = (np.add.outer(np.arange(h), 3 * np.arange(w)) % 256).astype(np.uint8)
    img[h // 3: 2 * h // 3] = ramp[h // 3: 2 * h // 3, :, None]
    img[2 * h // 3:, : w // 2] = 77
    return img[..., 0] if ch == 1 else img


def _filters(data: bytes) -> set:
    return set(png._parse(data, "x")[3][:, 0].tolist())


@pytest.mark.parametrize("shape", [(1, 1), (5, 3), (48, 64), (480, 640)])
def test_port_writes_what_pil_reads(shape, rng, tmp_path):
    img = rng.integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "a.png")
    png.write_png(path, img)
    with Image.open(path) as im:
        assert im.mode == "L"
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(png.read_png(path), img)


@pytest.mark.parametrize("mode", list(MODES))
def test_port_reads_what_pil_writes(mode, rng, tmp_path):
    seen = set()
    paths, wants = [], []
    for k, (h, w) in enumerate([(31, 45), (64, 80), (3, 7)]):
        path = str(tmp_path / f"{mode}{k}.png")
        Image.fromarray(_content(rng, h, w, MODES[mode]), mode).save(path)
        with open(path, "rb") as f:
            seen |= _filters(f.read())
        with Image.open(path) as im:
            wants.append(np.asarray(im.convert("L")))
        paths.append(path)
        np.testing.assert_array_equal(png.read_png(path), wants[-1])
    # together, as convert-euroc reads a sequence (same-shape files batched)
    for got, want in zip(png.read_pngs(paths + paths), wants + wants):
        np.testing.assert_array_equal(got, want)
    assert {1, 2, 4} <= seen  # Sub, Up and Paeth rows occurred


def _filter_row(kind: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    x, b = row.astype(np.int32), prev.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = [np.zeros_like(x), a, b, (a + b) // 2, paeth][kind]
    return ((x - pred) % 256).astype(np.uint8)


def _hand_png(img: np.ndarray, colour: int, kinds) -> bytes:
    h, w = img.shape[:2]
    bpp = img.shape[2] if img.ndim == 3 else 1
    rows = img.reshape(h, w * bpp)
    raw = bytearray()
    for r in range(h):
        prev = rows[r - 1] if r else np.zeros(w * bpp, np.uint8)
        raw += bytes([kinds[r]]) + _filter_row(kinds[r], rows[r], prev, bpp).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(bytes(raw))) + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("mode, colour", [("L", 0), ("LA", 4), ("RGB", 2), ("RGBA", 6)])
def test_all_five_filters(mode, colour, rng):
    h, w = 23, 37
    img = _content(rng, h, w, MODES[mode])
    kinds = [int(k) for k in rng.permutation(np.arange(h) % 5)]
    data = _hand_png(img, colour, kinds)
    assert _filters(data) == {0, 1, 2, 3, 4}
    want = np.asarray(Image.open(io.BytesIO(data)).convert("L"))
    got = png.decode_pngs([data])[0]
    np.testing.assert_array_equal(got, want)
    # one image unfiltered alone and in a batch of differing row filters
    other = _hand_png(img, colour, kinds[::-1])
    for g in png.decode_pngs([other, data, other]):
        np.testing.assert_array_equal(g, want)


def _camera_like(rng, h: int, w: int) -> np.ndarray:
    """Smooth shading with sensor noise and a flat (saturated) corner, as
    a camera frame has."""
    yy, xx = np.mgrid[0:h, 0:w]
    shade = 128 + 60 * np.sin(xx / 23.0) * np.cos(yy / 17.0) + 20 * np.sin((xx + yy) / 5.0)
    img = np.clip(shade + rng.normal(0.0, 3.0, (h, w)), 0, 255).astype(np.uint8)
    img[: h // 4, : w // 4] = 255
    return img


@pytest.mark.parametrize("shape, content", [((31, 45), "mixed"), ((48, 64), "camera"),
                                            ((480, 640), "camera")])
def test_smoke_encoder_filters_rows_as_pil(shape, content, rng):
    """``chip_smoke.encode_png_like_pil``, which writes the files on which
    the smoke times the reader's Average/Paeth path, filters every row as
    PIL's encoder does: the inflated image data (filter bytes and rows)
    equal PIL's, and the port reads the pixels back."""
    import chip_smoke

    img = (_content(rng, *shape, 1) if content == "mixed" else _camera_like(rng, *shape))
    buf = io.BytesIO()
    Image.fromarray(img, "L").save(buf, format="PNG")
    ours = chip_smoke.encode_png_like_pil(img)
    np.testing.assert_array_equal(png._parse(ours, "ours")[3], png._parse(buf.getvalue(), "pil")[3])
    assert {1, 4} <= _filters(ours)  # Sub and Paeth rows occur
    np.testing.assert_array_equal(png.decode_pngs([ours])[0], img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(ours))), img)


@pytest.mark.parametrize("kinds", [[1] * 6, [2] * 6, [0, 1, 2, 2, 1, 0]],
                         ids=["all-sub", "all-up", "mixed"])
def test_row_filters_without_average_or_paeth(kinds, rng):
    img = rng.integers(0, 256, (6, 9, 3)).astype(np.uint8)
    data = _hand_png(img, 2, kinds)
    np.testing.assert_array_equal(png.decode_pngs([data])[0],
                                  np.asarray(Image.open(io.BytesIO(data)).convert("L")))


@pytest.mark.parametrize("what, kwargs, match", [
    ("palette", dict(mode="P"), "palette"),
    ("16-bit", dict(mode="I;16"), "16-bit"),
    ("1-bit", dict(mode="1"), "1-bit"),
    ("interlaced", dict(mode="L", interlace=True), "interlaced"),
])
def test_refused_types_name_the_file(what, kwargs, match, rng, tmp_path):
    path = str(tmp_path / f"{what}.png")
    img = rng.integers(0, 256, (16, 16)).astype(np.uint8)
    mode = kwargs.pop("mode")
    if mode == "I;16":
        im = Image.fromarray(img.astype(np.uint16) * 257)
    else:
        im = Image.fromarray(img, "L").convert(mode)
    if what == "interlaced":
        # PIL writes no interlaced PNG: flip the IHDR's interlace byte of a
        # file with a single-pass-compatible body (read refuses it before
        # decoding)
        buf = io.BytesIO()
        im.save(buf, format="PNG")
        data = bytearray(buf.getvalue())
        ihdr = bytes(data[12:29])
        data[28] = 1
        data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
        assert ihdr != bytes(data[12:29])
        with open(path, "wb") as f:
            f.write(bytes(data))
    else:
        im.save(path, **kwargs)
    with pytest.raises(ValueError, match=match) as err:
        png.read_png(path)
    assert path in str(err.value)


def test_corrupt_files_are_refused(rng):
    data = bytearray(png.encode_png(rng.integers(0, 256, (4, 4)).astype(np.uint8)))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_pngs([b"GIF89a" + bytes(data[6:])])
    data[40] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        png.decode_pngs([bytes(data)], ["bad.png"])
