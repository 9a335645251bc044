"""The float32 work of the towers' low-channel layers, from their widths.

Block 3's ``conv0`` (2 -> 16, 7x7, stride 1, after the pool by 2) and
block 4's ``conv0`` (2 -> 8, 7x7, stride 1) and ``conv1`` (8 -> 16, 5x5,
stride 2): the layers with at most 16 output channels and C_in k^2 <= 200
at full or half resolution, which kernel V1 of the program
(``lowc_conv_kernel``) runs. Counted from the published widths
(``perfbench.reference.uahn.TOWERS``), the configuration's frame and the
traffic's batch, never from what implements the layers, so that a share of
their bound reads the same work whatever runs them: 2 x output pixels x
C_out x C_in k^2 a layer (the bias and the LeakyReLU are not counted).
Both cascades the benchmark knows run blocks 3 and 4.
"""

from __future__ import annotations

from perfbench.lib.counts import POOL, halved
from perfbench.reference.uahn import TOWERS

LOWC_LAYERS = (("block3", 0), ("block4", 0), ("block4", 1))  # (tower, layer)


def layer_flops(block: str, layer: int, h: int, w: int) -> int:
    """Multiply-adds x 2 of one tower layer on one pair of h x w frames
    (padding (k - 1) // 2, so a stride-2 layer rounds up)."""
    hh, ww, c_in = h // POOL[block], w // POOL[block], 2
    for i, (c_out, k, s) in enumerate(TOWERS[block][:layer + 1]):
        if s == 2:
            hh, ww = halved(hh, 1), halved(ww, 1)
        if i == layer:
            return 2 * hh * ww * c_out * c_in * k * k
        c_in = c_out
    raise ValueError(f"{block} has no layer {layer}")


def lowc_flops(config: dict, batch: int) -> int:
    """The three layers' FLOPs in one network call on ``batch`` pairs of the
    configuration's frames."""
    h, w = config["img_height"], config["img_width"]
    return batch * sum(layer_flops(b, i, h, w) for b, i in LOWC_LAYERS)
