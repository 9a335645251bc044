"""The box rule of the remap kernel C1 (``ops/remap.tile_boxes``), on the CPU.

C1 streams each output tile's raw box through shared memory when the box
fits a stage (``ops/cuda/remap.cu``; the kernel itself runs only on the
card, ``tests/test_torch_cuda.py``, which also holds the kernel's own count
of tiles by path to this rule). Here, on the maps that the card tests and
``chip_smoke.py`` use, and at raw sizes whose rows are 16-byte aligned
(640x480, EuRoC's 752x480) and not (641x479):

- every in-image tap of every tile lies inside its tile's box, and the box
  is the least one of whole 16-byte chunks that holds them;
- the camera maps' boxes (fisheye, radtan) fit the stage, so every tile of
  a real camera takes the shared path;
- the edge map (its four corners in one tile) puts a tile over the stage,
  and the scattered map every tile.
"""

import functools

import numpy as np
import pytest
import torch

from cuahn_vio_torch.ops import remap as tremap
from cuahn_vio_torch.runtime.undistort import build_undist_map

UZH_K = [275.46015578667294, 274.9948095922592, 315.958384100568, 242.7123497822731]
UZH_D = [-6.545154718304953e-06, -0.010379525898159981, 0.014935312423953146,
         -0.005639061406567785]  # Kannala-Brandt, the default config's
EUROC_K = [458.654, 457.296, 367.215, 248.375]
EUROC_D = [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]  # radtan
RAW_SIZES = [(480, 640), (479, 641), (480, 752)]
RAW_IDS = ["640x480", "641x479", "752x480"]


@functools.lru_cache(maxsize=None)
def _camera_map(kind: str):
    k, d = (UZH_K, UZH_D) if kind == "fisheye" else (EUROC_K, EUROC_D)
    return build_undist_map(k, d, kind == "fisheye", device="cpu")


def _maps(kind: str, src_h: int, src_w: int):
    """The card tests' maps (``tests/test_torch_cuda.py _remap_maps``)."""
    if kind in ("fisheye", "radtan"):
        return _camera_map(kind)
    if kind == "scattered":
        rng = np.random.default_rng(5)
        return (torch.as_tensor(rng.uniform(-3, src_w + 2, (224, 320)).astype(np.float32)),
                torch.as_tensor(rng.uniform(-3, src_h + 2, (224, 320)).astype(np.float32)))
    v, u = torch.meshgrid(torch.arange(224, dtype=torch.float32),
                          torch.arange(320, dtype=torch.float32), indexing="ij")
    mx, my = u * 2.1 - 20.0, v * 2.3 - 15.0
    mx[0, :6] = torch.tensor([-1.0, -0.5, src_w - 1.0, src_w - 0.5, float(src_w), float("nan")])
    my[1, :5] = torch.tensor([src_h - 1.0, src_h - 0.75, float(src_h), -1.0, 1e9])
    mx[2, :4] = torch.tensor([0.0, src_w - 1.0, 0.5, src_w - 1.5])
    my[2, :4] = torch.tensor([0.0, src_h - 1.0, src_h - 1.5, 0.25])
    return mx, my


def _taps(mx, my, src_h, src_w):
    """(pixel row, pixel column, raw row, raw column) of every in-image tap,
    each computed as the plain remap does."""
    nan = torch.isnan(mx) | torch.isnan(my)
    sx = torch.clamp(torch.where(nan, 0.0, mx), -tremap.COORD_CLIP, tremap.COORD_CLIP)
    sy = torch.clamp(torch.where(nan, 0.0, my), -tremap.COORD_CLIP, tremap.COORD_CLIP)
    x0, y0 = torch.floor(sx).long(), torch.floor(sy).long()
    v, u = torch.meshgrid(torch.arange(mx.shape[0]), torch.arange(mx.shape[1]), indexing="ij")
    out = []
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi < src_w) & (yi >= 0) & (yi < src_h) & ~nan
            out.append(torch.stack([v[inside], u[inside], yi[inside], xi[inside]], dim=1))
    return torch.cat(out)


@pytest.mark.parametrize("src_h, src_w", RAW_SIZES, ids=RAW_IDS)
@pytest.mark.parametrize("kind", ["fisheye", "radtan", "edges", "scattered"])
def test_every_in_image_tap_lies_in_its_tiles_box(kind, src_h, src_w):
    mx, my = _maps(kind, src_h, src_w)
    boxes = tremap.tile_boxes(mx, my, src_h, src_w)
    th, tw = tremap.TILE
    assert boxes["row0"].shape == (-(-224 // th), -(-320 // tw))
    taps = _taps(mx, my, src_h, src_w)
    ty, tx = taps[:, 0] // th, taps[:, 1] // tw
    r0, r1 = boxes["row0"][ty, tx], boxes["row1"][ty, tx]
    c0, c1 = boxes["col0"][ty, tx], boxes["col1"][ty, tx]
    assert ((taps[:, 2] >= r0) & (taps[:, 2] < r1) & (taps[:, 3] >= c0)
            & (taps[:, 3] < c1)).all()
    # the least such box: its rows are the taps' extremes, its columns those
    # widened to whole chunks; a tile without an in-image tap has no box
    tile = ty * boxes["row0"].shape[1] + tx
    n_tiles = boxes["row0"].numel()
    lo_r = torch.full((n_tiles,), 1 << 40).scatter_reduce(0, tile, taps[:, 2], "amin")
    hi_r = torch.full((n_tiles,), -1).scatter_reduce(0, tile, taps[:, 2], "amax")
    lo_c = torch.full((n_tiles,), 1 << 40).scatter_reduce(0, tile, taps[:, 3], "amin")
    hi_c = torch.full((n_tiles,), -1).scatter_reduce(0, tile, taps[:, 3], "amax")
    has = hi_r >= 0
    chunk = tremap.CHUNK
    np.testing.assert_array_equal(boxes["row0"].reshape(-1)[has], lo_r[has])
    np.testing.assert_array_equal(boxes["row1"].reshape(-1)[has], hi_r[has] + 1)
    np.testing.assert_array_equal(boxes["col0"].reshape(-1)[has], lo_c[has] // chunk * chunk)
    np.testing.assert_array_equal(boxes["col1"].reshape(-1)[has],
                                  hi_c[has] // chunk * chunk + chunk)
    assert (boxes["bytes"].reshape(-1)[~has] == 0).all()
    assert torch.equal(boxes["bytes"], (boxes["row1"] - boxes["row0"])
                       * (boxes["col1"] - boxes["col0"]))
    assert torch.equal(boxes["shared"], boxes["bytes"] <= tremap.STAGE_BYTES)


@pytest.mark.parametrize("src_h, src_w", RAW_SIZES, ids=RAW_IDS)
@pytest.mark.parametrize("kind", ["fisheye", "radtan"])
def test_camera_maps_stream_every_tile_through_shared_memory(kind, src_h, src_w):
    boxes = tremap.tile_boxes(*_maps(kind, src_h, src_w), src_h, src_w)
    assert boxes["shared"].all()
    assert int(boxes["bytes"].max()) <= tremap.STAGE_BYTES


@pytest.mark.parametrize("src_h, src_w", RAW_SIZES, ids=RAW_IDS)
@pytest.mark.parametrize("kind, over", [("edges", 1), ("scattered", 140)])
def test_spread_maps_put_tiles_over_the_stage(kind, over, src_h, src_w):
    boxes = tremap.tile_boxes(*_maps(kind, src_h, src_w), src_h, src_w)
    assert int((~boxes["shared"]).sum()) == over
    if kind == "edges":  # the corners' tile: the whole frame, in whole chunks
        assert (boxes["row0"][0, 0], boxes["row1"][0, 0]) == (0, src_h)
        assert (boxes["col0"][0, 0], boxes["col1"][0, 0]) == (0, -(-src_w // 16) * 16)


def test_tile_boxes_of_a_ragged_map_and_of_no_tap():
    """A 37x55 map has partial tiles at its right and bottom; a map whose
    every coordinate is off the frame or NaN has empty boxes (0 bytes, the
    shared path, nothing copied)."""
    mx, my = _maps("edges", 480, 640)
    boxes = tremap.tile_boxes(mx[:37, :55], my[:37, :55], 480, 640)
    assert boxes["row0"].shape == (3, 2)
    mx = torch.full((37, 55), -5.0)
    mx[0, 0] = float("nan")
    boxes = tremap.tile_boxes(mx, torch.full((37, 55), 3.0), 480, 640)
    assert (boxes["bytes"] == 0).all() and boxes["shared"].all()
