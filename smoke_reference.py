#!/usr/bin/env python3
"""The ATE references behind ``chip_smoke.py``'s bars, on the CPU.

    python3 smoke_reference.py OUT_DIR [--part single|batch|both]

``single`` (the single-stream slice's bar): makes the smoke's sequence
(``chip_smoke.SEQ``) with the port's ``make_sequence`` on the CPU and
writes it to OUT_DIR as ``seq.npz``, ``seq_gt.txt`` and ``seq_config.yaml``
(the config make-synthetic writes: calibrated profile, calib_dt 0,
init_height from the GT, init_imu_thresh 0.2). Then, for MC-dropout seeds
0, 1 and 2, runs it through the JAX package (``python -m cuahn_vio.cli
run-vio``) and through the port (``python -m cuahn_vio_torch.cli run-vio
--device cpu``) with the v10 weights, scores both with ``python -m
cuahn_vio.cli error-singlerun se3`` and prints one line per run with the
ATE pos rmse.

``batch`` (the batched phase's bars): also makes the three photo-texture
sequences (``chip_smoke.textured_sequences`` on the CPU, written as
``tex{i}.npz`` / ``tex{i}_gt.txt``), runs the four sequences for each seed
through ``python -m cuahn_vio.cli run-vio-batch`` and ``python -m
cuahn_vio_torch.cli run-vio-batch --device cpu`` with the v10 weights and
the slice's config, scores each sequence the same way, and prints per
sequence the JAX package's mean ATE, its seed-to-seed spread (max - min)
and the bar that ``chip_smoke.BATCH_ATE_BARS_M`` takes from them.

Needs JAX (for the reference runs) and PyYAML; a run takes minutes.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEEDS = (0, 1, 2)  # the spread of three seeds sets the smoke's ATE margins
MARGIN_M = 0.005  # the bars' margin over the JAX ATE ...
SPREAD_FACTOR = 5.0  # ... or this times its seed-to-seed spread, if larger
SPREAD_FLOOR_M = 0.001  # (the spread counts only above this)


def write_sequence(out_dir: str, stem: str, seq) -> str:
    from cuahn_vio_torch.eval.traj_io import save_pose_file

    path = os.path.join(out_dir, f"{stem}.npz")
    np.savez_compressed(path, imu_t=seq.imu_t, imu_w=seq.imu_w, imu_a=seq.imu_a,
                        cam_t=seq.cam_t, frames=seq.frames)
    save_pose_file(os.path.join(out_dir, f"{stem}_gt.txt"), seq.gt_times, seq.gt_pose_w)
    return path


def ate(env, gt: str, est: str) -> float:
    score = subprocess.run(
        [sys.executable, "-m", "cuahn_vio.cli", "error-singlerun", "se3", gt, est],
        env=env, check=True, capture_output=True, text=True, timeout=600,
    )
    return float(re.search(r"pos: rmse ([0-9.]+) m", score.stdout).group(1))


def run(env, cmd) -> None:
    subprocess.run([sys.executable, "-m", *cmd], env=env, check=True,
                   capture_output=True, text=True, timeout=7200)


RUNS = [("cuahn_vio", []), ("cuahn_vio_torch", ["--device", "cpu"])]


def single(env, out_dir: str, weights: str) -> None:
    path = lambda name: os.path.join(out_dir, name)  # noqa: E731
    for seed in SEEDS:
        for package, extra in RUNS:
            est = path(f"est_{package}_s{seed}.txt")
            run(env, [f"{package}.cli", "run-vio", path("seq.npz"),
                      "--config", path("seq_config.yaml"), "--weights", weights,
                      "--out", est, "--seed", str(seed), *extra])
            print(f"{package} seed {seed}: ATE pos rmse "
                  f"{ate(env, path('seq_gt.txt'), est):.5f} m", flush=True)


def batch(env, out_dir: str, weights: str, stems: list) -> None:
    path = lambda name: os.path.join(out_dir, name)  # noqa: E731
    jax_ates = {stem: [] for stem in stems}
    for seed in SEEDS:
        for package, extra in RUNS:
            out = path(f"batch_{package}_s{seed}")
            run(env, [f"{package}.cli", "run-vio-batch",
                      *[path(f"{stem}.npz") for stem in stems],
                      "--config", path("seq_config.yaml"), "--weights", weights,
                      "--out-dir", out, "--seed", str(seed), *extra])
            for stem in stems:
                value = ate(env, path(f"{stem}_gt.txt"), os.path.join(out, f"{stem}.txt"))
                if package == "cuahn_vio":
                    jax_ates[stem].append(value)
                print(f"batch {package} seed {seed} {stem}: ATE pos rmse {value:.5f} m",
                      flush=True)
    for stem, values in jax_ates.items():
        mean, spread = float(np.mean(values)), float(np.ptp(values))
        margin = max(MARGIN_M, SPREAD_FACTOR * spread) if spread > SPREAD_FLOOR_M else MARGIN_M
        print(f"batch bar {stem}: JAX mean {mean:.5f} m, spread {spread:.5f} m, "
              f"bar {mean + margin:.5f} m", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--part", choices=["single", "batch", "both"], default="both")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke
    from cuahn_vio_torch.data.synthetic import AnalyticTrajectory, make_sequence
    from cuahn_vio_torch.utils.config import VioOptions

    os.makedirs(args.out_dir, exist_ok=True)
    opts = VioOptions.uzhfpv_indoor45().apply_profile("calibrated")
    seq = make_sequence(AnalyticTrajectory(), np.asarray(opts.t_imu_to_cam),
                        device="cpu", **chip_smoke.SEQ)
    write_sequence(args.out_dir, "seq", seq)
    opts.calib_camimu_dt = 0.0
    opts.init_height = float(seq.gt_pose_w[0, 2])
    opts.init_imu_thresh = 0.2
    opts.to_yaml(os.path.join(args.out_dir, "seq_config.yaml"))

    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    if args.part in ("single", "both"):
        single(env, args.out_dir, chip_smoke.WEIGHTS)
    if args.part in ("batch", "both"):
        stems = ["seq"]
        for i, tex_seq in enumerate(chip_smoke.textured_sequences("cpu")):
            write_sequence(args.out_dir, f"tex{i}", tex_seq)
            stems.append(f"tex{i}")
        batch(env, args.out_dir, chip_smoke.WEIGHTS, stems)
    return 0


if __name__ == "__main__":
    sys.exit(main())
