"""UAHN: the content-and-uncertainty-aware homography network, in PyTorch.

Counterpart of ``cuahn_vio.models.uahn`` (the reference's 4-block cascaded
CNN, trace_pytorch_model/model_to_trace.py), batched over a leading dim
and in torch's NCHW layout:

- Part 1, blocks 1-3: coarse-to-fine refinement. Each block sees
  (img1, warp(img2, H)) average-pooled by 8/4/2, predicts a residual
  4-point offset, solves a DLT and right-composes H <- H @ H_block.
- Prior path: the filter's propagated 4-point offset (pixels) replaces
  block 1 (blocks_to_run=3, the shipped config), blocks 2 and 3.
- Block 4: the full-resolution 7-conv tower runs once; the mean and
  log-variance fc heads run as a 16-member MC-dropout ensemble.
  ensemble_var = empirical var of the means + mean(exp(logvar)), logvar
  scaled by 1e-3 and clamped to ±11.5.
- Covariance transfer into the original img2 frame, 8x8 block diagonal.
- On request (``forward(return_error_map=True)``, ``inspect-frame``), the
  photometric error map |warp(img2, H_total) - img1| * 255.

Training uses ``cascade_flows`` (the cumulative corner flow after each
part-1 block) and ``last_block_members``; every homography is detached
before it warps, as the JAX model stops its gradient, so no gradient
reaches a warp. No method depends on ``train()``/``eval()``.

Under a profiler the call is labelled by stage (``utils/spans``):
``vio.uahn.call`` around ``forward``, and inside it ``vio.uahn.prior``
(the prior's DLT), ``vio.uahn.block1``-``block3`` (each refinement:
warp, pool, tower, fc, DLT, compose), ``vio.uahn.masks`` (the MC-dropout
masks, T1's one launch), ``vio.uahn.block4`` (block 4's warp and
full-resolution tower), ``vio.uahn.heads`` (the 16-member heads and the
ensemble statistics) and ``vio.uahn.transfer`` (the covariance transfer
into the original frame). With no profiler a span costs a flag read.

Parameter names match the flax tree (``block2.conv0.weight`` for flax's
``block2/conv0/kernel``), so ``utils.checkpoint.load_params`` fills it.
MC-dropout masks come from JAX keys (``dropout_keys``, ``utils/prng``):
each batch row's four masks are the ones ``model.apply(...,
rngs={"dropout": key})`` of the JAX model draws for that row's key, all
of a call drawn in one launch of the threefry kernel T1. With
``compute_dtype=torch.bfloat16`` the four conv towers run in bfloat16
(cuDNN bf16 convolutions on the card), as the JAX ``compute_dtype`` does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cuahn_vio_torch.ops.homography import (
    block_diag_cov8,
    corner_points,
    dlt_solve,
    transfer_mean_var,
)
from cuahn_vio_torch.ops.warp import homography_warp
from cuahn_vio_torch.utils import prng
from cuahn_vio_torch.utils.spans import span

CONV_PLANES = (8, 16, 32, 64, 128, 256, 256)  # model_to_trace.py:88-89
IMG_HEIGHT, IMG_WIDTH = 224, 320  # the virtual camera
MC_DROPOUT_NUM = 16  # model_to_trace.py:201
LEAK = 0.1  # LeakyReLU slope, model_to_trace.py:12
# bound on the scaled aleatoric log-variance: exp(11.5) ~ 1e5 px^2 already
# means "no information", and an inf variance would poison the EKF solve
LOGVAR_CLAMP = 11.5
BLOCK_SPANS = ("vio.uahn.block1", "vio.uahn.block2", "vio.uahn.block3")  # of ``_refine``


class ConvTower(nn.Module):
    """(conv, LeakyReLU 0.1) layers; spec (out, k, stride), padding (k-1)//2.

    The layers run in ``compute_dtype``: the input and the (float32)
    weights are cast to it per call, and the output is cast back to
    float32 for the fc layers (the JAX ``ConvTower``'s ``dtype``)."""

    def __init__(self, in_channels: int, specs: Sequence[tuple[int, int, int]],
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        c = in_channels
        for i, (feat, k, s) in enumerate(specs):
            self.add_module(f"conv{i}", nn.Conv2d(c, feat, k, s, (k - 1) // 2))
            c = feat

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype
        x = x.to(dtype)
        for conv in self.children():
            x = F.conv2d(x, conv.weight.to(dtype), conv.bias.to(dtype), conv.stride,
                         conv.padding)
            x = F.leaky_relu(x, LEAK)
        return x.to(torch.float32)


def draw_masks(dropout_keys, rate: float, n_fc: int, device,
               batch: Optional[int] = None) -> Optional[tuple]:
    """The MC-dropout keep-masks of one network call, drawn in one launch:
    ``((mean Dropout_0, mean Dropout_1), (logvar Dropout_0, logvar
    Dropout_1))``, each (B, 16, width) bool (width n_fc, then 256), the
    masks of ``jax.random.bernoulli(site key, 1 - rate)``; None when
    ``rate`` is 0 (nothing is drawn).

    ``dropout_keys``: the call's keys, one per batch row: a (B, 4, 2)
    int32 tensor of the rows' mask keys (``prng.mask_keys``, in
    ``prng.MASK_SITES`` order), or a (B, 2) uint32 numpy array of the
    rows' call keys (folded here, then copied to ``device``); ``batch``,
    when given, is the call's B, which the keys must match."""
    if rate == 0.0:
        return None
    if dropout_keys is None:
        raise ValueError("MC-dropout at a rate > 0 needs dropout_keys")
    if isinstance(dropout_keys, np.ndarray):
        dropout_keys = prng.keys_tensor(prng.mask_keys(dropout_keys), device)
    if (dropout_keys.dim() != 3 or dropout_keys.shape[1:] != (4, 2)
            or batch not in (None, dropout_keys.shape[0])):
        raise ValueError(f"dropout_keys must be (B, 4, 2) for B = {batch}, got "
                         f"{tuple(dropout_keys.shape)}")
    b = dropout_keys.shape[0]
    widths = (n_fc, 256, n_fc, 256)
    counts = [MC_DROPOUT_NUM * w for w in widths] * b
    flat = prng.draw(dropout_keys.reshape(-1, 2), counts, prng.BERNOULLI, 1.0 - rate)
    rows = flat.view(torch.bool).view(b, -1)
    starts = np.cumsum((0,) + tuple(MC_DROPOUT_NUM * w for w in widths))
    masks = [rows[:, starts[i]:starts[i + 1]].view(b, MC_DROPOUT_NUM, w)
             for i, w in enumerate(widths)]
    return (masks[0], masks[1]), (masks[2], masks[3])


def _dropout(x: torch.Tensor, rate: float, mask: Optional[torch.Tensor]):
    """Always-on (MC) dropout: ``where(mask, x / keep, 0)`` (Flax's
    ``Dropout``); no mask passes ``x`` through (rate 0)."""
    if mask is None:
        return x
    return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))


class McHead(nn.Module):
    """A 2-layer fc head run as a 16-member MC-dropout ensemble:
    (B, fc_input) -> (B, 16, out)."""

    def __init__(self, fc_input: int, out_dim: int):
        super().__init__()
        self.fc0 = nn.Linear(fc_input, 256)
        self.fc1 = nn.Linear(256, out_dim)

    def forward(self, feat, rate: float, masks: Optional[tuple]):
        """``masks``: this head's (Dropout_0, Dropout_1) keep-masks
        (``draw_masks``), or None at rate 0."""
        m0, m1 = masks if masks is not None else (None, None)
        x = feat[:, None, :].expand(-1, MC_DROPOUT_NUM, -1)
        x = _dropout(x, rate, m0)
        x = F.leaky_relu(self.fc0(x), LEAK)
        x = _dropout(x, rate, m1)
        return self.fc1(x)


def fc_input(img_height: int, img_width: int) -> int:
    """Features of a tower's last map: 256 channels after the frame is
    halved six times (pooling by 2-8, then stride-2 convs padded by
    (k-1)//2, which round up): 5120 = 256 x 4 x 5 at 224x320, as the JAX
    model's lazily sized ``nn.Dense`` finds."""
    def halved(n: int) -> int:
        for _ in range(6):
            n = (n + 1) // 2
        return n

    return CONV_PLANES[6] * halved(img_height) * halved(img_width)


def _as_float(img: torch.Tensor) -> torch.Tensor:
    """uint8 frame -> float32 in [0, 1]; float32 passes through."""
    return img.to(torch.float32) / 255.0 if img.dtype == torch.uint8 else img


class UAHN(nn.Module):
    """The full 4-block network on (B, img_height, img_width) frames (uint8,
    or float32 in [0, 1]); 224x320 by default, the shipped size.

    ``use_prior`` and ``blocks_to_run`` select the cascade:
      use_prior=False          -> blocks {1,2,3,4}
      use_prior, blocks=3      -> blocks {2,3,4}     (shipped config)
      use_prior, blocks=2      -> blocks {3,4}
      use_prior, blocks=1      -> block  {4} on H_prior
    """

    def __init__(self, dropout_rate: float = 0.05, blocks_to_run: int = 3,
                 compute_dtype: torch.dtype = torch.float32,
                 img_height: int = IMG_HEIGHT, img_width: int = IMG_WIDTH):
        super().__init__()
        self.img_height, self.img_width = img_height, img_width
        self.dropout_rate = dropout_rate
        self.blocks_to_run = blocks_to_run
        p, dt, n_fc = CONV_PLANES, compute_dtype, fc_input(img_height, img_width)
        self.block1 = ConvTower(2, [(p[4], 7, 2), (p[4], 5, 2), (p[5], 3, 2)], dt)
        self.fc_block1 = nn.Linear(n_fc, 8)
        self.block2 = ConvTower(
            2, [(p[3], 7, 2), (p[4], 5, 2), (p[5], 3, 2), (p[6], 3, 2)], dt
        )
        self.fc_block2 = nn.Linear(n_fc, 8)
        self.block3 = ConvTower(
            2,
            [(p[1], 7, 1), (p[2], 5, 2), (p[3], 3, 2), (p[4], 3, 2),
             (p[5], 3, 2), (p[6], 3, 2)], dt,
        )
        self.fc_block3 = nn.Linear(n_fc, 8)
        self.block4 = ConvTower(
            2,
            [(p[0], 7, 1), (p[1], 5, 2), (p[2], 3, 2), (p[3], 3, 2),
             (p[4], 3, 2), (p[5], 3, 2), (p[6], 3, 2)], dt,
        )
        self.head_mean = McHead(n_fc, 8)
        self.head_logvar = McHead(n_fc, 8)
        self.register_buffer(
            "corners", corner_points(img_height, img_width), persistent=False
        )

    def _refine(self, block: int, img1, img2, h_uv):
        """Cascade block ``block`` (1-3): warp img2 by the current H (none
        for block 1), average-pool by 8, 4 or 2, predict a residual offset,
        DLT, right-compose.

        The incoming H is a constant to backprop (detached, the JAX model's
        ``stop_gradient``): each block learns to refine whatever estimate
        it is handed."""
        tower, fc = getattr(self, f"block{block}"), getattr(self, f"fc_block{block}")
        pool = 2 ** (4 - block)
        with span(BLOCK_SPANS[block - 1]):
            if h_uv is not None:
                h_uv = h_uv.detach()
            img2_in = _as_float(img2) if h_uv is None else homography_warp(img2, h_uv)
            pair = torch.stack([_as_float(img1), img2_in], dim=1)  # (B, 2, H, W)
            x = tower(F.avg_pool2d(pair, pool, pool))
            offset8 = fc(torch.flatten(x, 1))
            corners = self.corners.expand(offset8.shape[0], 4, 2)
            h_blk = dlt_solve(corners, corners + offset8.reshape(-1, 4, 2))
            return h_blk if h_uv is None else h_uv @ h_blk

    def _prior_h(self, prior_offset: Optional[torch.Tensor]) -> torch.Tensor:
        """The prior's homography (B, 3, 3): DLT of the corners moved by the
        propagated 4-point offset (B, 4, 2), pixels."""
        if prior_offset is None:
            raise ValueError("use_prior needs prior_offset (B, 4, 2)")
        with span("vio.uahn.prior"):
            corners = self.corners.expand(prior_offset.shape[0], 4, 2)
            return dlt_solve(corners, corners + prior_offset)

    def part1(self, img1, img2, prior_offset: Optional[torch.Tensor],
              use_prior: bool) -> torch.Tensor:
        """Blocks 1-3 -> part-1 homography (B, 3, 3)."""
        if use_prior:
            h_uv = self._prior_h(prior_offset)
            if self.blocks_to_run == 1:
                return h_uv
        else:
            h_uv = self._refine(1, img1, img2, None)
        if not use_prior or self.blocks_to_run == 3:
            h_uv = self._refine(2, img1, img2, h_uv)
        if not use_prior or self.blocks_to_run >= 2:
            h_uv = self._refine(3, img1, img2, h_uv)
        return h_uv

    def _tower4(self, img1, img2, h_uv, dropout_keys):
        """The call's masks (``draw_masks``; drawn first, since they do not
        depend on the frames) and block 4's tower on img2 warped by
        ``h_uv``: (features (B, fc_input), masks)."""
        with span("vio.uahn.masks"):
            masks = draw_masks(dropout_keys, self.dropout_rate,
                               self.head_mean.fc0.in_features, img1.device, img1.shape[0])
        with span("vio.uahn.block4"):
            pair = torch.stack([_as_float(img1), homography_warp(img2, h_uv.detach())], dim=1)
            return torch.flatten(self.block4(pair), 1), masks

    def _members(self, feat, masks):
        """The 16 MC-dropout members of the heads on block 4's features:
        (means (B, 16, 4, 2), logvars (B, 16, 4, 2))."""
        b = feat.shape[0]
        mean_masks, logvar_masks = masks if masks is not None else (None, None)
        means = self.head_mean(feat, self.dropout_rate, mean_masks)
        logvars = self.head_logvar(feat, self.dropout_rate, logvar_masks) * 1e-3
        return (means.reshape(b, MC_DROPOUT_NUM, 4, 2),
                logvars.reshape(b, MC_DROPOUT_NUM, 4, 2))

    def last_block_members(self, img1, img2, h_uv, dropout_keys=None):
        """Block 4 tower (once) + the 16 MC-dropout members on img2 warped
        by ``h_uv``, a constant to backprop (detached, as every caller of
        the JAX method stops its gradient). ``dropout_keys``: one key per
        batch row (``draw_masks``).
        Returns (means (B, 16, 4, 2), logvars (B, 16, 4, 2)) in the
        warped-img2 frame."""
        feat, masks = self._tower4(img1, img2, h_uv, dropout_keys)
        with span("vio.uahn.heads"):
            return self._members(feat, masks)

    def last_block(self, img1, img2, h_uv, dropout_keys=None):
        """Block 4 + ensemble statistics: (corner prediction (B, 4, 2),
        ensemble variance (B, 4, 2)), warped frame."""
        feat, masks = self._tower4(img1, img2, h_uv, dropout_keys)
        with span("vio.uahn.heads"):
            means, logvars = self._members(feat, masks)
            logvars = torch.clamp(logvars, -LOGVAR_CLAMP, LOGVAR_CLAMP)
            mean_avg = means.mean(dim=1)
            var_avg = torch.exp(logvars).mean(dim=1)
            emp_var = torch.square(means - mean_avg[:, None]).mean(dim=1)
            return self.corners + mean_avg, emp_var + var_avg

    def _flow_of(self, h_uv: torch.Tensor) -> torch.Tensor:
        """(B, 8) corner flow, pixels, of homographies (B, 3, 3)."""
        uv1 = torch.cat([self.corners, torch.ones_like(self.corners[:, :1])], dim=1)
        m = uv1 @ h_uv.transpose(-1, -2)  # (B, 4, 3)
        return (m[..., :2] / m[..., 2:3] - self.corners).reshape(-1, 8)

    def cascade_flows(self, img1: torch.Tensor, img2: torch.Tensor,
                      prior_offset: Optional[torch.Tensor] = None,
                      use_prior: bool = False):
        """Training forward of part 1: the cumulative corner flow (pixels,
        original img2 frame) after each executed block, and the final H.

        Returns (flows (B, n_executed, 8), h_uv (B, 3, 3)). Supervising each
        stage's flow against the true flow trains the cascade as the
        reference's progressive scheme does.
        """
        flows = []
        if use_prior:
            h_uv = self._prior_h(prior_offset)
            if self.blocks_to_run == 1:
                return self._flow_of(h_uv)[:, None], h_uv
        else:
            h_uv = self._refine(1, img1, img2, None)
            flows.append(self._flow_of(h_uv))
        if not use_prior or self.blocks_to_run == 3:
            h_uv = self._refine(2, img1, img2, h_uv)
            flows.append(self._flow_of(h_uv))
        if not use_prior or self.blocks_to_run >= 2:
            h_uv = self._refine(3, img1, img2, h_uv)
            flows.append(self._flow_of(h_uv))
        return torch.stack(flows, dim=1), h_uv

    @torch.no_grad()
    def forward(self, img1: torch.Tensor, img2: torch.Tensor,
                prior_offset: Optional[torch.Tensor] = None,
                use_prior: bool = False,
                dropout_keys=None,
                return_error_map: bool = False):
        """Full model (combined_stu_model.forward), without autograd.

        Args:
            img1, img2: (B, H, W) uint8 frames or float32 in [0, 1].
            prior_offset: (B, 4, 2) propagated 4-point offset, pixels.
            use_prior: select the prior cascade.
            dropout_keys: the MC-dropout keys, one per batch row: (B, 4,
                2) int32 mask keys on the frames' device, or (B, 2) uint32
                numpy call keys (``draw_masks``); unused at rate 0.
            return_error_map: also return the photometric error map
                |warp(img2, H_total) - img1| * 255, H_total = H_part1 @
                DLT(corners -> block 4's corner prediction).
        Returns:
            flow8 (B, 8): total 4-point flow, pixels, original frame.
            cov88 (B, 8, 8): block-diagonal measurement covariance, px².
            [err_map (B, H, W) float32, if requested.]
        """
        with span("vio.uahn.call"):
            flow8, cov88, h_part1, warped_4pt = self._flow_cov_h(
                img1, img2, prior_offset, use_prior, dropout_keys)
            if not return_error_map:
                return flow8, cov88
            corners = self.corners.expand(warped_4pt.shape[0], 4, 2)
            h_total = h_part1 @ dlt_solve(corners, warped_4pt)
            err_map = torch.abs(homography_warp(img2, h_total) - _as_float(img1)) * 255.0
            return flow8, cov88, err_map

    def flow_and_cov(self, img1: torch.Tensor, img2: torch.Tensor,
                     prior_offset: Optional[torch.Tensor] = None,
                     use_prior: bool = False,
                     dropout_keys=None):
        """``forward`` with autograd on, the filter-in-the-loop trainer's
        call: gradients reach block 4's tower and heads through the
        ensemble statistics, ``transfer_mean_var`` and ``block_diag_cov8``.
        The part-1 homography is a constant to backprop (computed without
        autograd, the JAX model's ``stop_gradient``), so blocks 1-3 and the
        prior get none."""
        return self._flow_cov_h(img1, img2, prior_offset, use_prior, dropout_keys)[:2]

    def _flow_cov_h(self, img1, img2, prior_offset, use_prior, dropout_keys):
        """(flow8, cov88, the part-1 homography, block 4's corner
        prediction in the warped frame)."""
        with torch.no_grad():
            h_part1 = self.part1(img1, img2, prior_offset, use_prior)
        warped_4pt, ens_var = self.last_block(img1, img2, h_part1, dropout_keys)
        with span("vio.uahn.transfer"):
            pts_orig, cov_4pt = transfer_mean_var(ens_var, h_part1, warped_4pt)
            flow8 = (pts_orig - self.corners).reshape(-1, 8)
            return flow8, block_diag_cov8(cov_4pt), h_part1, warped_4pt


# the std of a unit normal truncated at +-2 (jax.nn.initializers.variance_scaling)
TRUNC_NORMAL_STD = 0.87962566103423978


def init_uahn(key, img_height: int = IMG_HEIGHT, img_width: int = IMG_WIDTH,
              blocks_to_run: int = 3, compute_dtype: torch.dtype = torch.float32,
              device="cuda", dropout_rate: float = 0.05) -> UAHN:
    """The UAHN on ``device``, in eval mode, with the parameters of the JAX
    ``init_uahn(key, ...)``: Flax's ``model.init({"params": key, ...})``.

    Each conv and dense kernel is LeCun normal, ``variance_scaling(1,
    "fan_in", "truncated_normal")``: ``truncated_normal(k, -2, 2, shape) *
    (sqrt(float32(1 / fan_in)) / float32(TRUNC_NORMAL_STD))`` in float32,
    drawn in Flax's layout (conv HWIO, fan_in = kh kw c_in; dense (in, out),
    fan_in = in) and then carried into the port's (``kernel_to_port``).
    Its key k is the first ``make_rng("params")`` of its module's scope,
    ``flax_fold(key, <path below the root>, 1)`` (``block2/conv0``,
    ``fc_block1``, ``head_mean/fc0``); every bias is 0. All kernels are
    drawn in one T1 launch on a GPU. ``key``: (2,) uint32 (``prng_key``)."""
    from cuahn_vio_torch.utils.checkpoint import flax_kernel_shape, kernel_to_port

    model = UAHN(dropout_rate, blocks_to_run, compute_dtype, img_height, img_width)
    model = model.to(device).eval()
    kernels = [(n, p) for n, p in model.named_parameters() if n.endswith(".weight")]
    keys = np.stack([prng.flax_fold(key, *n[:-len(".weight")].split("."), 1) for n, _ in kernels])
    draws = prng.truncated_normal(prng.keys_tensor(keys, device),
                                  [flax_kernel_shape(p.shape) for _, p in kernels], -2.0, 2.0)
    with torch.no_grad():
        for (name, p), z in zip(kernels, draws):
            std = np.sqrt(np.float32(1.0 / p[0].numel())) / np.float32(TRUNC_NORMAL_STD)
            p.copy_(kernel_to_port(z * float(std), name))
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.zero_()
    return model


def build_uahn(state_dict: Optional[dict] = None, device="cuda",
               dropout_rate: float = 0.05, blocks_to_run: int = 3,
               compute_dtype: torch.dtype = torch.float32,
               img_height: int = IMG_HEIGHT, img_width: int = IMG_WIDTH) -> UAHN:
    """The UAHN (224x320 by default) on ``device``, in eval mode, with
    ``state_dict`` loaded (PyTorch's default init when None: a weightless
    verb takes ``init_uahn``). ``compute_dtype=
    torch.bfloat16`` runs the conv towers in bfloat16 (``run-vio --bf16``);
    the weights stay float32, and the warps, DLTs, fc heads and covariance
    path float32."""
    model = UAHN(dropout_rate, blocks_to_run, compute_dtype, img_height, img_width)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model.to(device).eval()
