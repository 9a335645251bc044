"""Loop-closure pairs through the prior-mode UAHN, as ``close-loops`` runs it.

The traffic (``perfbench/traffic/<name>.json``) gives the flight and the
call: a double loop of ``laps`` laps of ``lap_s`` seconds at ``cam_hz``,
candidate pairs at least ``min_dt_s`` apart and within ``max_dist_m``,
priors from poses with drift-like noise inside the ``max_prior_px`` gate,
``batches`` distinct calls of ``batch`` pairs drawn from the candidates.
Every seed makes the same number of calls of the same shapes; the flight,
the ground and the pairs change.

A unit is one network call, ``UAHN.forward(img_i, img_j, prior,
use_prior=True, dropout_keys=...)`` on frames gathered from the flight on
the device, with candidate pair n's masks drawn from ``fold_in(PRNGKey(
seed), n)`` as ``pipeline/loop_closure.generate_loop_factors`` folds
them. Every call's outputs are kept; after the window a sample of calls
drawn from the seed is recomputed by the plain reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.lib import counts, scene, threefry
from perfbench.lib.flax_msgpack import load_tree
from perfbench.reference.uahn import PlainUAHN, weights_from_tree

KEY_TABLE_CALLS = 4096  # calls whose keys are made in set-up; the window wraps


def double_loop(rng: np.random.Generator, t: np.ndarray, lap_s: float):
    """IMU poses (R_wi (N, 3, 3), p_wi (N, 3)) of a double loop: a circle
    of radius 1.2-1.8 m flown ``lap_s`` a lap at a fixed heading, drifting
    0.1-0.3 m a lap sideways, the height 1.2-2.0 m, with 3-6 degrees of
    roll and pitch rocking."""
    radius = rng.uniform(1.2, 1.8)
    drift = rng.uniform(0.1, 0.3) / lap_s
    w = 2.0 * math.pi / lap_s
    h0, hz, wz = rng.uniform(1.4, 1.8), rng.uniform(0.1, 0.2), rng.uniform(0.6, 1.1)
    p = np.stack([radius * (1 - np.cos(w * t)) + drift * t, radius * np.sin(w * t),
                  h0 + hz * np.sin(wz * t)], -1)
    rock = np.radians(rng.uniform(3.0, 6.0))
    yaw0 = rng.uniform(-math.pi, math.pi)
    r = scene.euler_to_rot(rock * np.sin(1.7 * t), rock * np.sin(1.3 * t + 1.0),
                           yaw0 + 0.02 * np.sin(0.5 * t))
    return r, p


def drifted(rng, r_wi, p_wi, t):
    """The poses an estimator would hold: a random walk of 0.03 m/sqrt(s)
    in position and 0.5 deg/sqrt(s) in yaw added to the truth."""
    dt = np.diff(t, prepend=t[0])
    dp = np.cumsum(rng.normal(size=(len(t), 3)) * 0.03 * np.sqrt(dt)[:, None], 0)
    dyaw = np.cumsum(rng.normal(size=len(t)) * math.radians(0.5) * np.sqrt(dt))
    z = np.zeros_like(dyaw)
    return scene.euler_to_rot(z, z, dyaw) @ r_wi, p_wi + dp


class Work:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, model_factory=None):
        self.cfg, self.tr, self.seed, self.dev = cfg, traffic, seed, torch.device(device)
        self.h, self.w = cfg["img_height"], cfg["img_width"]
        self.model_factory = model_factory
        self.outputs = []

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from cuahn_vio_torch.models.uahn import build_uahn
        from cuahn_vio_torch.ops.homography import f32_parity_mode
        from cuahn_vio_torch.utils import prng
        from cuahn_vio_torch.utils.checkpoint import load_params

        tr, cfg = self.tr, self.cfg
        rng = np.random.default_rng([self.seed & 0xFFFFFFFF, self.seed >> 32, 1])
        f32_parity_mode()
        model = build_uahn(load_params(cfg["weights"]), device=self.dev, dropout_rate=cfg["mc_dropout"],
                           blocks_to_run=cfg["blocks_to_run"], img_height=self.h,
                           img_width=self.w)
        self.model = model if self.model_factory is None else self.model_factory(model)

        t = np.arange(0.0, tr["laps"] * tr["lap_s"], 1.0 / tr["cam_hz"])
        r_wi, p_wi = double_loop(rng, t, tr["lap_s"])
        r_est, p_est = drifted(rng, r_wi, p_wi, t)
        self.waves = scene.ground_waves(rng)
        r_wc, c_w = scene.camera_poses(r_wi, p_wi, cfg)
        self.frames = scene.render(r_wc, c_w, self.waves, self.h, self.w, self.dev)

        # candidates: i before j by min_dt_s, estimated positions within
        # max_dist_m, the prior from the estimates inside the gate
        n_min = int(round(tr["min_dt_s"] * tr["cam_hz"]))
        ii, jj = np.nonzero(np.triu(np.ones((len(t), len(t)), bool), n_min))
        near = np.linalg.norm(p_est[ii] - p_est[jj], axis=1) < tr["max_dist_m"]
        ii, jj = ii[near], jj[near]
        re_wc, ce_w = scene.camera_poses(r_est, p_est, cfg)
        prior = scene.corner_flow(re_wc[ii], ce_w[ii], re_wc[jj], ce_w[jj], self.h, self.w)
        inside = np.isfinite(prior).all(axis=(1, 2)) & (np.abs(prior).max(axis=(1, 2))
                                                        <= tr["max_prior_px"])
        ii, jj, prior = ii[inside], jj[inside], prior[inside]
        n_pairs = tr["batches"] * tr["batch"]
        if len(ii) < n_pairs:
            raise RuntimeError(f"{len(ii)} candidate pairs, {n_pairs} needed")
        pick = rng.choice(len(ii), n_pairs, replace=False)
        shape = (tr["batches"], tr["batch"])
        self.idx_i = torch.as_tensor(ii[pick].reshape(shape), device=self.dev)
        self.idx_j = torch.as_tensor(jj[pick].reshape(shape), device=self.dev)
        self.prior = torch.tensor(prior[pick].reshape(*shape, 4, 2), dtype=torch.float32,
                                  device=self.dev)
        # call c's pair r is candidate n = c * batch + r of the run
        n = np.arange(KEY_TABLE_CALLS * tr["batch"])
        self.call_keys = prng.fold_in(prng.prng_key(self.seed), n).reshape(
            KEY_TABLE_CALLS, tr["batch"], 2)
        self.mask_keys = prng.keys_tensor(prng.mask_keys(self.call_keys), self.dev)
        for c in range(2):  # every shape of the window: cuDNN's first calls
            self.unit(c)
        self.outputs.clear()

    # ------------------------------------------------------------ window
    def unit(self, c: int) -> None:
        b, k = c % self.tr["batches"], c % KEY_TABLE_CALLS
        flow8, cov88 = self.model(self.frames[self.idx_i[b]], self.frames[self.idx_j[b]],
                                  self.prior[b], use_prior=True, dropout_keys=self.mask_keys[k])
        self.outputs.append((c, flow8, cov88))

    def items(self, units: int) -> dict:
        return {"pairs": units * self.tr["batch"]}

    def counts(self) -> dict:
        b = self.tr["batch"]
        n_fc = counts.fc_input(self.h, self.w)
        return {
            "flops_per_unit": b * counts.uahn_flops("prior3", self.h, self.w),
            "warp_bytes": counts.warp_bytes(b, self.h, self.w, 1),
            "t1_values": b * counts.MC * 2 * (n_fc + 256),
        }

    def release(self) -> None:
        self.model = None
        self.outs_host = [(c, f.cpu(), cv.cpu()) for c, f, cv in self.outputs]
        self.outputs = []

    # ------------------------------------------------------------ check
    def reference(self, tf32: bool = False):
        """The plain reference on this run's inputs (weights read again from
        the raw file)."""
        ref = PlainUAHN(weights_from_tree(load_tree(self.cfg["weights"]), self.dev),
                        self.cfg["mc_dropout"], self.h, self.w, self.dev)

        def call(c):
            b, k = c % self.tr["batches"], c % KEY_TABLE_CALLS
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
                prev = torch.backends.cuda.matmul.allow_tf32
                torch.backends.cuda.matmul.allow_tf32 = tf32
                try:
                    return ref(self.frames[self.idx_i[b]], self.frames[self.idx_j[b]],
                               self.prior[b], threefry.mask_keys(self.call_keys[k]))
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = prev
        return call

    def check(self, control: bool = False) -> tuple[dict, int, int]:
        """({name: reading}, attempted, failed): the widest gap of flow8 (px)
        and of cov88 (relative to the pair's largest entry) between the
        program's outputs and the reference's over a sample of the
        window's calls drawn from the seed. ``control``: the reference
        computed with TF32 takes the program's place."""
        outs = self.outs_host
        ok = [torch.isfinite(f).all(1) & torch.isfinite(cv).all((1, 2)) for _, f, cv in outs]
        failed = sum(int((~k).sum()) for k in ok)
        rng = np.random.default_rng([self.seed & 0xFFFFFFFF, self.seed >> 32, 2])
        sample = rng.choice(len(outs), min(self.tr["check_calls"], len(outs)), replace=False)
        ref, low = self.reference(False), self.reference(True) if control else None
        flow_gap, cov_gap = 0.0, 0.0
        for i in sample:
            c, f, cv = outs[i]
            f_ref, c_ref = ref(c)
            f, cv = low(c) if control else (f.to(self.dev), cv.to(self.dev))
            flow_gap = max(flow_gap, float((f - f_ref).abs().max()))
            scale = c_ref.abs().amax(dim=(1, 2), keepdim=True)
            cov_gap = max(cov_gap, float(((cv - c_ref).abs() / scale).max()))
        if failed:
            flow_gap = cov_gap = float("inf")
        return ({"flow_gap_px": flow_gap, "cov_gap_rel": cov_gap},
                len(outs) * self.tr["batch"], failed)
