"""The yardstick's arithmetic: operations and bytes from shapes, and peaks.

Everything here is counted from the published widths and the shapes of a
call, never from what a kernel happens to do, so that a roofline share
reads the same work whatever implements the kernel.

- ``conv_flops``: 2 x output pixels x C_out x (C_in k k) a convolution;
  a tower's convolutions from ``TOWERS``, the pooled input size and the
  stride-2 layers' rounding up (padding (k - 1) // 2).
- ``uahn_flops``: the convolutions of the towers a call runs and the two
  16-member heads (fc0 and fc1 of each member), per pair.
- ``warp_bytes``: kernel B2's byte bound, a frozen copy of
  ``chip_smoke.warp_bound_ms``'s bytes: each input byte read once (image
  and homography), each output float written once.
- ``t1_function_clocks``: kernel T1's bound from its function alone, a
  frozen copy of ``sass_bound.t1_function_bound``: threefry's 41 ALU-only
  operations and 32 adds a value plus the mode's own, the adds put on the
  ALU or the IMAD pipe so that the busiest pipe or the issue slots are
  least busy.
- ``PEAKS``: the card's published rates (NVIDIA's H100 SXM data sheet).
"""

from __future__ import annotations

from perfbench.reference.uahn import PLANES, TOWERS

POOL = {"block1": 8, "block2": 4, "block3": 2, "block4": 1}
MC = 16
# the towers each cascade runs: prior mode with blocks_to_run 3, and the
# full cascade
CASCADES = {"prior3": ("block2", "block3", "block4"),
            "full": ("block1", "block2", "block3", "block4")}

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes": 3.35e12, "sms": 132,
                              "max_sm_mhz": 1980.0},
}

# issue slots and pipes of one SM, in lanes a clock (sass_bound.LANES)
LANES = {"issue": 128, "alu": 64, "imad": 64, "fma_imad": 128, "xu": 16}
T1_HASH_OPS = {"alu": 41, "add": 32}
T1_MODE_OPS = {
    "bits": {},
    "uniform": {"alu": 3, "fma": 2},
    "bernoulli": {"alu": 2},
    "normal": {"alu": 6, "fma": 16, "xu": 1},
    "truncated_normal": {"alu": 8, "fma": 16, "xu": 1},
}


def halved(n: int, times: int) -> int:
    for _ in range(times):
        n = (n + 1) // 2
    return n


def tower_flops(block: str, h: int, w: int) -> int:
    """Multiply-adds x 2 of one tower's convolutions on one pair."""
    hh, ww = h // POOL[block], w // POOL[block]
    c_in, total = 2, 0
    for c_out, k, s in TOWERS[block]:
        if s == 2:
            hh, ww = halved(hh, 1), halved(ww, 1)
        total += 2 * hh * ww * c_out * c_in * k * k
        c_in = c_out
    return total


def fc_input(h: int, w: int) -> int:
    return PLANES[6] * halved(h, 6) * halved(w, 6)


def head_flops(h: int, w: int) -> int:
    """The two 16-member heads (fc0: fc_input -> 256, fc1: 256 -> 8)."""
    return 2 * MC * 2 * (fc_input(h, w) * 256 + 256 * 8)


def uahn_flops(cascade: str, h: int, w: int) -> int:
    """One pair through the towers of ``cascade``, their block fcs and the
    heads."""
    blocks = CASCADES[cascade]
    convs = sum(tower_flops(b, h, w) for b in blocks)
    block_fcs = sum(2 * fc_input(h, w) * 8 for b in blocks if b != "block4")
    return convs + block_fcs + head_flops(h, w)


def warp_bytes(batch: int, h: int, w: int, pixel_bytes: int) -> int:
    return batch * (h * w * pixel_bytes + 9 * 4) + batch * h * w * 4


def clocks_per_item(c: dict) -> float:
    need = (c.get("total", 0) / LANES["issue"], c.get("alu", 0) / LANES["alu"],
            c.get("imad", 0) / LANES["imad"],
            (c.get("fma", 0) + c.get("imad", 0)) / LANES["fma_imad"],
            c.get("xu", 0) / LANES["xu"])
    return max(need)


def t1_function_clocks(mode: str) -> float:
    """SM clocks a value of T1's ``mode`` needs at the least."""
    ops = dict(T1_HASH_OPS)
    for k, v in T1_MODE_OPS[mode].items():
        ops[k] = ops.get(k, 0) + v
    adds = ops.pop("add")
    best = None
    for on_alu in range(adds + 1):
        c = dict(ops, alu=ops.get("alu", 0) + on_alu, imad=adds - on_alu)
        c["total"] = sum(c.values())
        clk = clocks_per_item(c)
        best = clk if best is None else min(best, clk)
    return best


def t1_bound_s(mode: str, values: int, peaks: dict) -> float:
    return t1_function_clocks(mode) * values / (peaks["sms"] * peaks["max_sm_mhz"] * 1e6)
