"""The float32 work of the towers' layers of blocks 2-4 that V1 leaves,
from their widths.

Every layer of block 2's, block 3's and block 4's towers but V1's three
(``conv_counts.LOWC_LAYERS``): fourteen layers, which kernel V2 of the
program (``gemm_conv_kernel``) runs. Counted from the published widths
(``perfbench.reference.uahn.TOWERS``), the configuration's frame, its
cascade and the traffic's batch, never from what implements the layers,
so that a share of their bound reads the same work whatever runs them:
2 x output pixels x C_out x C_in k^2 a layer (``conv_counts.layer_flops``;
the bias and the LeakyReLU are not counted). Block 1's layers are left
out: the prior-mode cascade does not run them, and the count is the same
in either cascade.
"""

from __future__ import annotations

from perfbench.lib.conv_counts import LOWC_LAYERS, layer_flops
from perfbench.reference.uahn import TOWERS

GEMM_LAYERS = tuple((block, i) for block in ("block2", "block3", "block4")
                    for i in range(len(TOWERS[block])) if (block, i) not in LOWC_LAYERS)


def gemm_flops(config: dict, batch: int) -> int:
    """The fourteen layers' FLOPs in one network call on ``batch`` pairs of
    the configuration's frames."""
    h, w = config["img_height"], config["img_width"]
    return batch * sum(layer_flops(b, i, h, w) for b, i in GEMM_LAYERS)
