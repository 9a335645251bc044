"""ctypes binding and wrappers of H1, the UAHN's two 16-member MC-dropout
heads as one kernel pair (``heads.cu``).

``mc_heads(feat, masks, rate, heads, corners)`` is what ``UAHN._members``
and ``UAHN._statistics`` compute from block 4's features: each head's
members ``fc1(dropout(leaky_relu(fc0(dropout(feat)))))`` (the log-variance
head's times 1e-3), then the ensemble's corner prediction and variance
(``ensemble_statistics``). On a CUDA tensor it is one call of the C
launcher, two launches (fc0 of both heads split over K, then the tail),
counted in ``launch_counts["mc_heads"]``; on a CPU tensor its plain
version, the same sums in plain PyTorch. ``takes`` is the UAHN's dispatch:
the heads go to H1 only on the card, in float32, with autograd off, at a
dropout rate above 0 with masks drawn, and at fc0's shape 5120 -> 256.
The library is built with nvcc at first use (``build.py``), never at
import, so this module imports on a machine without CUDA.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch
import torch.nn.functional as F

from cuahn_vio_torch.ops.cuda import build, launch_counts
from cuahn_vio_torch.ops.cuda.conv import LEAK, rounding_bound

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "heads.cu")
MEMBERS = 16  # MC-dropout members a pair (the UAHN's MC_DROPOUT_NUM)
IN, HIDDEN, OUT = 5120, 256, 8  # fc0: IN -> HIDDEN, fc1: HIDDEN -> OUT
SPLITS = 8  # fc0's K ranges, each summed alone (heads.cu's kSplits)
LOGVAR_SCALE = 1e-3  # the log-variance head's output scale
# bound on the scaled aleatoric log-variance: exp(11.5) ~ 1e5 px^2 already
# means "no information", and an inf variance would poison the EKF solve
LOGVAR_CLAMP = 11.5
LAUNCHES = 2  # a call's launches: fc0, then the tail
_P = ctypes.c_void_p
_ARGS = (_P,) * 13 + (ctypes.c_longlong,) + (_P,) * 5 + (ctypes.c_int, ctypes.c_float, _P)
U = 2.0 ** -24  # float32's unit roundoff


def ensemble_statistics(means: torch.Tensor, logvars: torch.Tensor,
                        corners: torch.Tensor) -> tuple:
    """The ensemble's corner prediction and variance (B, 4, 2), warped
    frame, from its members (B, 16, 4, 2): the members' mean plus the
    corners, and the members' spread plus the mean of exp(log-variance),
    the log-variances clamped to +-LOGVAR_CLAMP."""
    logvars = torch.clamp(logvars, -LOGVAR_CLAMP, LOGVAR_CLAMP)
    mean_avg = means.mean(dim=1)
    var_avg = torch.exp(logvars).mean(dim=1)
    emp_var = torch.square(means - mean_avg[:, None]).mean(dim=1)
    return corners + mean_avg, emp_var + var_avg


def _check(feat, masks, rate: float, heads, corners) -> None:
    """Shapes and dtypes that H1 and its plain version take."""
    if feat.dim() != 2 or feat.shape[1] != IN or feat.dtype != torch.float32:
        raise ValueError(f"H1 takes float32 features (B, {IN}); got {feat.dtype} "
                         f"{tuple(feat.shape)}")
    if not 0.0 < rate < 1.0 or masks is None or len(masks) != 2 or len(heads) != 2:
        raise ValueError(f"H1 takes a rate in (0, 1) with each head's two masks; got rate {rate}")
    b = feat.shape[0]
    for head, (m0, m1) in zip(heads, masks):
        shapes = [(head.fc0.weight, (HIDDEN, IN)), (head.fc0.bias, (HIDDEN,)),
                  (head.fc1.weight, (OUT, HIDDEN)), (head.fc1.bias, (OUT,))]
        if any(p.shape != s or p.dtype != torch.float32 for p, s in shapes):
            raise ValueError(f"H1 takes float32 heads {IN} -> {HIDDEN} -> {OUT}")
        if (m0.shape != (b, MEMBERS, IN) or m1.shape != (b, MEMBERS, HIDDEN)
                or m0.dtype != torch.bool or m1.dtype != torch.bool):
            raise ValueError(f"H1 takes bool masks (B, {MEMBERS}, {IN}) and (B, {MEMBERS}, "
                             f"{HIDDEN}); got {m0.dtype} {tuple(m0.shape)}, {m1.dtype} "
                             f"{tuple(m1.shape)}")
    if corners.shape != (4, 2) or corners.dtype != torch.float32:
        raise ValueError(f"H1 takes float32 corners (4, 2); got {tuple(corners.shape)}")


def heads_plain(feat: torch.Tensor, masks, rate: float, heads, corners: torch.Tensor) -> tuple:
    """H1's function in plain PyTorch: ``Dropout_0`` as ``where(mask, x /
    keep, 0)`` (a true division, Flax's), fc0 as ``SPLITS`` products over
    equal ranges of K added in range order, then the bias, the LeakyReLU,
    ``Dropout_1``, fc1 with its bias and the log-variance head's 1e-3; then
    ``ensemble_statistics``. Each range's product sums in the library's
    order, not the kernel's, so the two differ by rounding alone
    (``rounding_bounds``). Returns (members (B, 2, 16, 8): the mean head's,
    then the log-variance head's; pred (B, 4, 2); var (B, 4, 2))."""
    _check(feat, masks, rate, heads, corners)
    keep = torch.full((), 1.0 - rate, dtype=torch.float32, device=feat.device)  # a CUDA graph
    span = IN // SPLITS  # can hold its fill, not a copy from the host
    outs = []
    for head, (m0, m1) in zip(heads, masks):
        x = torch.where(m0, feat[:, None, :] / keep, 0.0)
        w0 = head.fc0.weight
        h = x[..., :span] @ w0[:, :span].T
        for s in range(1, SPLITS):
            h = h + x[..., s * span:(s + 1) * span] @ w0[:, s * span:(s + 1) * span].T
        h = F.leaky_relu(h + head.fc0.bias, LEAK)
        outs.append(F.linear(torch.where(m1, h / keep, 0.0), head.fc1.weight, head.fc1.bias))
    outs[1] = outs[1] * LOGVAR_SCALE
    members = torch.stack(outs, dim=1)
    b = feat.shape[0]
    pred, var = ensemble_statistics(members[:, 0].reshape(b, MEMBERS, 4, 2),
                                    members[:, 1].reshape(b, MEMBERS, 4, 2), corners)
    return members, pred, var


def rounding_bounds(feat: torch.Tensor, masks, rate: float, heads, corners: torch.Tensor,
                    members: torch.Tensor) -> tuple:
    """How far two float32 evaluations of H1's function may lie apart, per
    output: (members (B, 2, 16, 8), pred (B, 4, 2), var (B, 4, 2)).
    ``members``: one evaluation's (for the magnitudes of the statistics'
    terms).

    fc0 and fc1 each sum their products and bias, in whatever order,
    within ``conv.rounding_bound`` (a linear layer as a 1x1 convolution);
    the LeakyReLU's product and the division by keep add a rounding each
    side of each hidden unit's magnitude, and fc1 carries fc0's distance
    through its weights' magnitudes; the 1e-3 adds one rounding. The
    statistics: each sum of the 16 members within 2 (16 + 1) u of its
    terms' magnitudes plus its terms' own distances, exp within 8 u of its
    value (a rounding of 2 ulp on the card, 1 on the CPU) plus its
    argument's distance times the larger value, one rounding each side of
    each difference, square and final add."""
    keep = 1.0 - rate
    n = float(MEMBERS)
    bounds = []
    for head, (m0, m1) in zip(heads, masks):
        a = torch.where(m0, feat.abs()[:, None, :] / keep, 0.0).reshape(-1, IN, 1, 1)
        w0, b0 = head.fc0.weight.abs(), head.fc0.bias.abs()
        mag_h = F.linear(a.reshape(-1, IN), w0) + b0
        e_h = rounding_bound(a, w0[:, :, None, None], b0, 1).reshape(mag_h.shape)
        e_2 = torch.where(m1.reshape(-1, HIDDEN), (e_h + 4 * U * mag_h) / keep, 0.0)
        mag_2 = torch.where(m1.reshape(-1, HIDDEN), mag_h / keep, 0.0)
        w1, b1 = head.fc1.weight.abs(), head.fc1.bias.abs()
        e_out = F.linear(e_2, w1) + rounding_bound(mag_2[:, :, None, None], w1[:, :, None, None],
                                                   b1, 1).reshape(-1, OUT)
        bounds.append(e_out.reshape(feat.shape[0], MEMBERS, OUT))
    bounds[1] = bounds[1] * LOGVAR_SCALE + 2 * U * (members[:, 1].abs() + bounds[1] * LOGVAR_SCALE)
    e_m, e_v = bounds
    means, logvars = members[:, 0], members[:, 1]
    d_a = (e_m.sum(1) + 2 * (n + 1) * U * (means.abs() + e_m).sum(1)) / n
    mean_avg = means.mean(1)
    pred_b = d_a + 2 * U * (corners.abs().reshape(1, OUT) + mean_avg.abs() + d_a)
    dev = (means - mean_avg[:, None]).abs()
    g = e_m + d_a[:, None] + 2 * U * (dev + e_m + d_a[:, None])
    sq = (dev + g) ** 2
    emp_b = ((2 * dev * g + g * g + 2 * U * sq).sum(1) + 2 * (n + 1) * U * sq.sum(1)) / n
    big = torch.exp(torch.clamp(torch.clamp(logvars, -LOGVAR_CLAMP, LOGVAR_CLAMP) + e_v,
                                max=LOGVAR_CLAMP))
    ev_b = ((big * e_v + 8 * U * big).sum(1) + 2 * (n + 1) * U * big.sum(1)) / n
    var_b = emp_b + ev_b + 2 * U * (sq.sum(1) + big.sum(1)) / n
    b = feat.shape[0]
    return (torch.stack(bounds, 1), pred_b.reshape(b, 4, 2), var_b.reshape(b, 4, 2))


@functools.lru_cache(maxsize=None)
def _launcher():
    """H1's C launcher, its library loaded and its K splits checked."""
    splits = build.entry(SOURCE, "mc_heads_splits", ())()
    if splits != SPLITS:
        raise RuntimeError(f"heads.cu splits fc0 {splits} ways, heads.py {SPLITS}")
    return build.entry(SOURCE, "mc_heads_f32", _ARGS)


def build_kernel() -> float:
    """Build the library now; returns the compile seconds (0.0 if it was
    already built). Loading it needs a card, so it is left to the first
    launch."""
    return build.build(SOURCE)[1]


def ptxas_report() -> dict:
    """ptxas's registers, shared memory and spills of H1's kernels
    (``build.ptxas_report``)."""
    return build.ptxas_report(build.library_path(SOURCE))


def takes(feat: torch.Tensor, masks, rate: float, heads) -> bool:
    """Whether the UAHN runs its heads on ``feat`` through H1: on a CUDA
    device, float32 features, while autograd records nothing, at a rate
    above 0 with masks drawn, and with each head's fc0 5120 -> 256 and fc1
    256 -> 8 in float32. Every other call keeps ``McHead``'s ``F.linear``
    and ``_dropout`` and the statistics in torch."""
    return (feat.device.type == "cuda" and feat.dtype == torch.float32
            and not torch.is_grad_enabled() and rate > 0.0 and masks is not None
            and all((h.fc0.in_features, h.fc0.out_features, h.fc1.out_features)
                    == (IN, HIDDEN, OUT) and h.fc0.weight.dtype == torch.float32
                    and h.fc1.weight.dtype == torch.float32 for h in heads))


def mc_heads_cuda(feat: torch.Tensor, masks, rate: float, heads, corners: torch.Tensor) -> tuple:
    """One call of H1's launcher (two launches) on CUDA tensors: the
    features contiguous, the weights and corners contiguous on the same
    device, the four masks views of one buffer with one pair stride
    (``UAHN.draw_masks``'s); raises on anything the kernels do not take and
    on a failed launch. Returns what ``heads_plain`` returns."""
    _check(feat, masks, rate, heads, corners)
    params = [p for h in heads for p in (h.fc0.weight, h.fc0.bias, h.fc1.weight, h.fc1.bias)]
    flat_masks = [m for pair in masks for m in pair]
    tensors = [feat, corners, *params, *flat_masks]
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError("H1 takes CUDA tensors on one device")
    if not all(t.is_contiguous() for t in [feat, corners, *params]):
        raise ValueError("H1 takes contiguous features, weights and corners")
    b = feat.shape[0]
    stride = flat_masks[0].stride(0)  # one pair's stride is never read
    if (any(m.stride()[1:] != (m.shape[2], 1) or b > 1 and m.stride(0) != stride
            for m in flat_masks) or stride % 8 or any(m.data_ptr() % 8 for m in flat_masks[::2])):
        raise ValueError("H1 takes masks of one pair stride, a multiple of 8, each row "
                         "contiguous, the Dropout_0 masks 8-byte aligned")
    dev = feat.device
    ws = torch.empty((2, SPLITS, b * MEMBERS, HIDDEN), dtype=torch.float32, device=dev)
    members = torch.empty((b, 2, MEMBERS, OUT), dtype=torch.float32, device=dev)
    pred = torch.empty((b, 4, 2), dtype=torch.float32, device=dev)
    var = torch.empty((b, 4, 2), dtype=torch.float32, device=dev)
    mean_head, logvar_head = params[:4], params[4:]
    (m0m, m1m), (m0l, m1l) = masks
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(feat.data_ptr(), *(p.data_ptr() for p in mean_head + logvar_head),
                          m0m.data_ptr(), m1m.data_ptr(), m0l.data_ptr(), m1l.data_ptr(),
                          stride, corners.data_ptr(), ws.data_ptr(), members.data_ptr(),
                          pred.data_ptr(), var.data_ptr(), b, 1.0 - rate, stream)
    if err != 0:
        raise RuntimeError(f"mc_heads kernel launch failed: cudaError {err}")
    launch_counts["mc_heads"] += LAUNCHES
    return members, pred, var


def mc_heads(feat: torch.Tensor, masks, rate: float, heads, corners: torch.Tensor) -> tuple:
    """H1 on a CUDA tensor (``mc_heads_cuda``), its plain version on a CPU
    one."""
    if feat.is_cuda:
        return mc_heads_cuda(feat, masks, rate, heads, corners)
    return heads_plain(feat, masks, rate, heads, corners)
