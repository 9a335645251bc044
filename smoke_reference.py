#!/usr/bin/env python3
"""The ATE references behind ``chip_smoke.py``'s bars, on the CPU.

    python3 smoke_reference.py OUT_DIR [--part single|batch|bf16|raw|loop|diag|tune|prng|train|both]

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

``bf16`` (the bf16 phase's bar): runs the smoke's sequence for each seed
through ``python -m cuahn_vio.cli run-vio --bf16`` (bfloat16 conv towers)
and ``python -m cuahn_vio_torch.cli run-vio --bf16 --device cpu`` with the
v10 weights, scores each the same way, and prints the JAX package's mean
ATE and the bar that ``chip_smoke.BF16_ATE_BAR_M`` takes from it (+ 0.005
m, the margin of ``chip_smoke.ATE_BAR_M``).

``raw`` (the raw-camera phase's bar): makes phase 10's GT pose file and
phase 12's sequence with the port's ``make-synthetic`` on the CPU, over
the card machine's texture bank (its 12 procedural textures; this
machine's bank may hold photos too), in OUT_DIR/raw. Then, for each seed,
the JAX chain (``python -m cuahn_vio.cli distort-to-euroc``,
``convert-euroc``, ``run-vio`` with the v10 weights) and the port's on the
CPU, and the JAX package's ``run-vio`` on the rendered frames without the
round trip, each scored with the JAX ``error-singlerun se3``; prints the
JAX chain's mean ATE, its spread and the bar of ``chip_smoke.RAW_ATE_BAR_M``
(the rule of the batch bars).

``loop`` (the loop-closure phase's bar): makes phase 13's sequence with the
port's ``make-synthetic --traj-file`` on the CPU over the card machine's
texture bank, in OUT_DIR/loop (``chip_smoke.write_loop_trajectory``,
``chip_smoke.LOOP_SYNTH_ARGS``). Then, for each seed, the JAX chain
(``python -m cuahn_vio.cli run-vio --state-out``, ``close-loops`` with
``chip_smoke.LOOP_CLOSE_ARGS``, ``smooth-trajectory --loops-file``) and the
port's on the CPU, each scored before and after smoothing with the JAX
``error-singlerun se3``; prints the JAX mean smoothed ATE, its spread and
the bar of ``chip_smoke.LOOP_ATE_BAR_M`` (that mean + 0.005 m).

``diag`` (the diagnostics phase's bars): makes phase 10's sequence with the
port's ``make-synthetic`` on the CPU over the card machine's texture bank,
in OUT_DIR/diag. Then, for each seed, the JAX package's ``eval-flow`` with
the v10 weights (``--prior gt`` over every pair, and ``--prior none
--limit`` ``chip_smoke.DIAG_NONE_LIMIT``) and the port's on the CPU,
printing each run's lines; the JAX ``track-features`` and the port's
(their survivors from frame 0); and the JAX mean corner-error RMSE of each
prior, its spread and the bar of ``chip_smoke.FLOW_RMSE_BARS_PX`` (that
mean + ``chip_smoke.FLOW_RMSE_MARGIN_PX``).

``tune`` (phase 16's references): makes the smoke's sequence as ``single``
does, runs it through the JAX package's ``run-vio --state-out`` with the v10
weights at seed 0, and writes the three keys of that log that
``tune-filter`` reads (``times``, ``net_mean``, ``net_cov88``) to
``chip_smoke.TUNE_LOG``, and the JAX ``tune-filter`` rows of ``chip_smoke.TUNE_GRID`` (256 points)
to ``chip_smoke.TUNE_ROWS``, all under ``tests/data/``. Then the port's
``tune-filter --device cpu`` on the same files, printing its largest
``ate_pos`` difference from the JAX rows (``chip_smoke.TUNE_ATE_TOL_M``
is set from it), and the JAX package's single-process
``distributed-selftest`` checksums on 8 fake CPU devices
(``chip_smoke.JAX_SELFTEST``). ~10 min on the CPU.

``prng`` (the random-stream phase's reference, seconds): draws with JAX
alone and writes ``chip_smoke.PRNG_REF`` (``tests/data/prng_jax.npz``):
``PRNGKey`` of ``chip_smoke.PRNG_SEEDS``, ``split(PRNGKey(42), 6)``,
``fold_in(PRNGKey(42), d)`` for ``chip_smoke.PRNG_FOLDS``, and for the
keys ``fold_in(PRNGKey(42), i)``, i < 3, ``jax.random.bits``, ``uniform``
on [0.3, 1.7), ``bernoulli(0.95)`` and ``normal`` of
``chip_smoke.PRNG_COUNT`` values each; and the four MC-dropout masks
(packed bits) of the smoke's first network call, phase 4's first frame
pair at seed 0 (``fold_in(split(PRNGKey(0), F)[0], 0)``: ``split``'s first
key does not depend on F), captured where Flax's ``Dropout`` draws them
in a live ``UAHN.apply`` at 224x320.

``prng`` also writes ``jax.random.randint`` over ``chip_smoke.PRNG_SPANS``
and ``truncated_normal`` on (-2, 2) of ``chip_smoke.PRNG_COUNT`` values
for the same keys.

``train`` (the trainers' draws, seconds): writes ``chip_smoke.TRAIN_DRAWS``
(``tests/data/train_draws_jax.npz``), the JAX draws of phase 11's first
step (``train-uahn``'s defaults at batch ``chip_smoke.TRAIN_BATCH``, seed
0: ``sample_pair``'s draws of ``split(kb, B)``, kb = ``split(PRNGKey(0),
3)[1]``, as the pairs' poses, textures, transforms, exposures, effects and
prior noise), of its probe batch (``split(PRNGKey(20240817), 32)`` on the
held-out textures) and of phase 14's first FIL step (``window_loss``'s
draws of ``split(ks, FIL_BATCH)``, ks = ``split(PRNGKey(0), 3)[2]``), on
the card machine's texture bank (12 textures: its training split of 10
and held-out split of 2), with the first ``chip_smoke.DRAW_NOISE_VALUES``
values of every noise image.

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


def bf16(env, out_dir: str, weights: str, runs=RUNS) -> None:
    path = lambda name: os.path.join(out_dir, name)  # noqa: E731
    jax_ates = []
    for seed in SEEDS:
        for package, extra in runs:
            est = path(f"est_bf16_{package}_s{seed}.txt")
            run(env, [f"{package}.cli", "run-vio", path("seq.npz"),
                      "--config", path("seq_config.yaml"), "--weights", weights,
                      "--out", est, "--seed", str(seed), "--bf16", *extra])
            value = ate(env, path("seq_gt.txt"), est)
            if package == "cuahn_vio":
                jax_ates.append(value)
            print(f"bf16 {package} seed {seed}: ATE pos rmse {value:.5f} m", flush=True)
    if jax_ates:
        mean = float(np.mean(jax_ates))
        print(f"bf16 bar: JAX mean {mean:.5f} m, spread {float(np.ptp(jax_ates)):.5f} m, "
              f"bar {mean + MARGIN_M:.5f} m", flush=True)


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


def card_texture_bank() -> None:
    """Give this process the card machine's texture bank: the 12
    procedural textures (no image package is installed there)."""
    from cuahn_vio_torch.data import textures

    textures._BANK_CACHE = textures.quantize_u8(
        np.stack(textures._procedural_extras(textures.TEXTURE_SIZE)))


def raw(env, out_dir: str, weights: str) -> None:
    import chip_smoke
    from cuahn_vio_torch import cli as tcli

    card_texture_bank()
    work = os.path.join(out_dir, "raw")
    os.makedirs(work, exist_ok=True)
    path = lambda name: os.path.join(work, name)  # noqa: E731
    noise = chip_smoke.CLI_NOISE
    cwd = os.getcwd()
    os.chdir(work)
    try:  # phase 10's make-synthetic, then phase 12's
        tcli.main(["make-synthetic", "--device", "cpu", "--out", "seq.npz", "--duration",
                   str(chip_smoke.CLI_DURATION_S), "--texture", "heldout", "--seed", "7",
                   *noise])
        tcli.main(["make-synthetic", "--device", "cpu", "--traj-file", "seq_gt.txt",
                   "--spline-dt", "0.1", "--out", "raw_seq.npz", "--duration",
                   str(chip_smoke.RAW_DURATION_S), "--texture", "heldout", "--exposure-ms", "8",
                   "--effects", "--seed", "7", *noise])
    finally:
        os.chdir(cwd)
    cfg = ["--config", path("raw_seq_config.yaml")]
    for package, extra in RUNS:
        run(env, [f"{package}.cli", "distort-to-euroc", path("raw_seq.npz"), "--out",
                  path(f"euroc_{package}"), *cfg, *extra])
        run(env, [f"{package}.cli", "convert-euroc", path(f"euroc_{package}"), "--out",
                  path(f"conv_{package}.npz"), *cfg, *extra])
    jax_ates = []
    for seed in SEEDS:
        for package, extra in RUNS:
            est = path(f"est_{package}_s{seed}.txt")
            run(env, [f"{package}.cli", "run-vio", path(f"conv_{package}.npz"), *cfg,
                      "--weights", weights, "--out", est, "--seed", str(seed), *extra])
            value = ate(env, path("raw_seq_gt.txt"), est)
            if package == "cuahn_vio":
                jax_ates.append(value)
            print(f"raw chain {package} seed {seed}: ATE pos rmse {value:.5f} m", flush=True)
        est = path(f"est_virtual_s{seed}.txt")
        run(env, ["cuahn_vio.cli", "run-vio", path("raw_seq.npz"), *cfg, "--weights", weights,
                  "--out", est, "--seed", str(seed)])
        print(f"virtual frames cuahn_vio seed {seed}: ATE pos rmse "
              f"{ate(env, path('raw_seq_gt.txt'), est):.5f} m", flush=True)
    mean, spread = float(np.mean(jax_ates)), float(np.ptp(jax_ates))
    margin = max(MARGIN_M, SPREAD_FACTOR * spread) if spread > SPREAD_FLOOR_M else MARGIN_M
    print(f"raw bar: JAX mean {mean:.5f} m, spread {spread:.5f} m, bar {mean + margin:.5f} m",
          flush=True)


def loop(env, out_dir: str, weights: str) -> None:
    import chip_smoke
    from cuahn_vio_torch import cli as tcli

    card_texture_bank()
    work = os.path.join(out_dir, "loop")
    os.makedirs(work, exist_ok=True)
    path = lambda name: os.path.join(work, name)  # noqa: E731
    chip_smoke.write_loop_trajectory(path("loopy_traj.txt"))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        tcli.main(["make-synthetic", "--device", "cpu", "--out", "replay.npz", "--traj-file",
                   "loopy_traj.txt", *chip_smoke.LOOP_SYNTH_ARGS])
    finally:
        os.chdir(cwd)
    cfg = ["--config", path("replay_config.yaml")]
    jax_ates = []
    for seed in SEEDS:
        for package, extra in RUNS:
            tag = f"{package}_s{seed}"
            run(env, [f"{package}.cli", "run-vio", path("replay.npz"), *cfg, "--weights",
                      weights, "--out", path(f"est_{tag}.txt"), "--state-out",
                      path(f"state_{tag}.npz"), "--seed", str(seed), *extra])
            run(env, [f"{package}.cli", "close-loops", path("replay.npz"),
                      path(f"state_{tag}.npz"), "--weights", weights, *cfg, "--out",
                      path(f"loops_{tag}.txt"), *chip_smoke.LOOP_CLOSE_ARGS, *extra])
            run(env, [f"{package}.cli", "smooth-trajectory", path(f"est_{tag}.txt"),
                      "--loops-file", path(f"loops_{tag}.txt"), "--out",
                      path(f"smoothed_{tag}.txt"), *extra])
            factors = len(np.loadtxt(path(f"loops_{tag}.txt"), ndmin=2))
            before = ate(env, path("replay_gt.txt"), path(f"est_{tag}.txt"))
            after = ate(env, path("replay_gt.txt"), path(f"smoothed_{tag}.txt"))
            if package == "cuahn_vio":
                jax_ates.append(after)
            print(f"loop {package} seed {seed}: {factors} factors, ATE pos rmse online "
                  f"{before:.5f} m, smoothed {after:.5f} m", flush=True)
    mean, spread = float(np.mean(jax_ates)), float(np.ptp(jax_ates))
    print(f"loop bar: JAX mean smoothed {mean:.5f} m, spread {spread:.5f} m, bar "
          f"{mean + MARGIN_M:.5f} m", flush=True)


def diag(env, out_dir: str, weights: str) -> None:
    import chip_smoke
    from cuahn_vio_torch import cli as tcli

    card_texture_bank()
    work = os.path.join(out_dir, "diag")
    os.makedirs(work, exist_ok=True)
    path = lambda name: os.path.join(work, name)  # noqa: E731
    cwd = os.getcwd()
    os.chdir(work)
    try:  # phase 10's make-synthetic
        tcli.main(["make-synthetic", "--device", "cpu", "--out", "seq.npz", "--duration",
                   str(chip_smoke.CLI_DURATION_S), "--texture", "heldout", "--seed", "7",
                   *chip_smoke.CLI_NOISE])
    finally:
        os.chdir(cwd)
    priors = {"gt": [], "none": ["--limit", str(chip_smoke.DIAG_NONE_LIMIT)]}
    jax_rmse = {prior: [] for prior in priors}
    for seed in SEEDS:
        for prior, extra in priors.items():
            for package, dev in RUNS:
                said = subprocess.run(
                    [sys.executable, "-m", f"{package}.cli", "eval-flow", path("seq.npz"),
                     path("seq_state_gt.txt"), "--weights", weights, "--prior", prior,
                     "--seed", str(seed), *extra, *dev],
                    env=env, check=True, capture_output=True, text=True, timeout=3600).stdout
                for line in said.splitlines():
                    print(f"eval-flow {package} prior {prior} seed {seed}: {line}", flush=True)
                rmse = float(re.search(r"corner error  px: rmse ([0-9.]+)", said).group(1))
                if package == "cuahn_vio":
                    jax_rmse[prior].append(rmse)
    for package, dev in RUNS:
        said = subprocess.run(
            [sys.executable, "-m", f"{package}.cli", "track-features", path("seq.npz"),
             "--out", path(f"tracks_{package}.npz"), *dev],
            env=env, check=True, capture_output=True, text=True, timeout=3600).stdout
        print(f"track-features {package}: {said.splitlines()[0]}", flush=True)
    for prior, values in jax_rmse.items():
        mean, spread = float(np.mean(values)), float(np.ptp(values))
        print(f"eval-flow bar prior {prior}: JAX mean rmse {mean:.4f} px, spread "
              f"{spread:.4f} px, bar {mean + chip_smoke.FLOW_RMSE_MARGIN_PX:.4f} px", flush=True)


def tune(env, out_dir: str, weights: str) -> None:
    import json

    import chip_smoke

    path = lambda name: os.path.join(out_dir, name)  # noqa: E731
    run(env, ["cuahn_vio.cli", "run-vio", path("seq.npz"), "--config", path("seq_config.yaml"),
              "--weights", weights, "--out", path("est_tune.txt"), "--state-out",
              path("state_tune.npz"), "--seed", "0"])
    log = np.load(path("state_tune.npz"))
    np.savez_compressed(os.path.join(REPO, chip_smoke.TUNE_LOG),
                        **{k: log[k] for k in ("times", "net_mean", "net_cov88")})
    log_path = os.path.join(REPO, chip_smoke.TUNE_LOG)
    args = [path("seq.npz"), log_path, path("seq_gt.txt"), "--config", path("seq_config.yaml"),
            *chip_smoke.TUNE_GRID]
    run(env, ["cuahn_vio.cli", "tune-filter", *args, "--out",
              os.path.join(REPO, chip_smoke.TUNE_ROWS)])
    run(env, ["cuahn_vio_torch.cli", "tune-filter", *args, "--out", path("rows_port.jsonl"),
              "--device", "cpu"])
    rows = [{r["grid_index"]: r for r in map(json.loads, open(f))}
            for f in (os.path.join(REPO, chip_smoke.TUNE_ROWS), path("rows_port.jsonl"))]
    finite = [g for g, r in rows[0].items() if np.isfinite(r["ate_pos"])]
    diff = max(abs(rows[0][g]["ate_pos"] - rows[1][g]["ate_pos"]) for g in finite)
    same_inf = all(np.isinf(rows[0][g]["ate_pos"]) == np.isinf(rows[1][g]["ate_pos"])
                   for g in rows[0])
    print(f"tune: {len(rows[0])} JAX rows, {len(finite)} finite; port on the CPU: largest "
          f"ate_pos difference {diff:.3e} m, same inf pattern {same_inf}", flush=True)
    sel = subprocess.run(
        [sys.executable, "-c", "import json; from cuahn_vio.parallel.selftest import "
         "run_selftest; print(json.dumps(run_selftest(8)))"],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8"), check=True,
        capture_output=True, text=True, timeout=1800)
    print(f"JAX single-process selftest: {sel.stdout.strip()}", flush=True)


def prng_reference() -> None:
    import chip_smoke
    import flax.linen.stochastic as stochastic
    import jax
    import jax.numpy as jnp

    from cuahn_vio.models.uahn import UAHN

    def data(key):
        return np.asarray(jax.random.key_data(key) if jnp.issubdtype(
            key.dtype, jax.dtypes.prng_key) else key)

    base = jax.random.PRNGKey(42)
    keys = jnp.stack([jax.random.fold_in(base, i) for i in range(3)])
    n = chip_smoke.PRNG_COUNT
    out = dict(
        seeds=np.asarray(chip_smoke.PRNG_SEEDS, np.int64),
        seed_keys=np.stack([data(jax.random.PRNGKey(s)) for s in chip_smoke.PRNG_SEEDS]),
        split6=data(jax.random.split(base, 6)),
        folds=np.asarray(chip_smoke.PRNG_FOLDS, np.int64),
        fold_keys=np.stack([data(jax.random.fold_in(base, d)) for d in chip_smoke.PRNG_FOLDS]),
        draw_keys=data(keys),
        bits=np.stack([np.asarray(jax.random.bits(k, (n,), jnp.uint32)) for k in keys]),
        uniform=np.stack([np.asarray(jax.random.uniform(k, (n,), minval=0.3, maxval=1.7))
                          for k in keys]),
        bernoulli=np.stack([np.asarray(jax.random.bernoulli(k, 0.95, (n,))) for k in keys]),
        normal=np.stack([np.asarray(jax.random.normal(k, (n,))) for k in keys]),
        spans=np.asarray(chip_smoke.PRNG_SPANS, np.int64),
        randint=np.stack([np.stack([np.asarray(jax.random.randint(k, (n,), lo, hi))
                                    for k in keys]) for lo, hi in chip_smoke.PRNG_SPANS]),
        truncated_normal=np.stack([np.asarray(jax.random.truncated_normal(k, -2, 2, (n,)))
                                   for k in keys]),
    )
    call_key = jax.random.fold_in(jax.random.split(jax.random.PRNGKey(0), 1)[0], 0)
    drawn = []
    bernoulli = stochastic.random.bernoulli

    def capture(rng, p, shape):
        mask = bernoulli(rng, p, shape)
        drawn.append(np.asarray(mask))
        return mask

    model = UAHN()
    img = jnp.zeros((224, 320), jnp.float32)
    params = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                        img, img)["params"]
    stochastic.random.bernoulli = capture
    try:
        model.apply({"params": params}, img, img, jnp.zeros((4, 2)), use_prior=True,
                    rngs={"dropout": call_key})
    finally:
        stochastic.random.bernoulli = bernoulli
    out["mask_call_key"] = data(call_key)
    for name, mask in zip(("mean0", "mean1", "logvar0", "logvar1"), drawn):
        out[f"mask_{name}"] = np.packbits(mask.reshape(-1))
        out[f"mask_{name}_shape"] = np.asarray(mask.shape, np.int64)
    path = os.path.join(REPO, chip_smoke.PRNG_REF)
    np.savez_compressed(path, **out)
    print(f"prng: wrote {path} ({os.path.getsize(path)} bytes); masks "
          f"{[m.shape for m in drawn]}", flush=True)


def jax_pair_draws(keys, cfg, tex_indices, n_noise: int, hw: tuple) -> dict:
    """The JAX ``sample_pair``'s draws of each sample key (no pose-pair
    bank, photo ground with effects), named as the port's ``PairDraws``,
    and the first ``n_noise`` values of each frame's read and shot noise
    image, (2 frames, 2 kinds, B, n_noise)."""
    import jax
    import jax.numpy as jnp

    from cuahn_vio.data import sensor_effects as jfx
    from cuahn_vio.data import textures as jtex
    from cuahn_vio.ops.quat import quat_exp, quat_mul

    assert cfg.use_textures and cfg.use_effects and cfg.big_baseline_prob == 0.0

    def one(k):
        ks = jax.random.split(k, 16)
        p1 = jnp.array([0.0, 0.0, 0.0]).at[2].set(jax.random.uniform(
            ks[0], minval=cfg.height_range[0], maxval=cfg.height_range[1]))
        q1 = quat_exp(jnp.concatenate([
            jax.random.normal(ks[1], (2,)) * cfg.tilt_sigma,
            jax.random.uniform(ks[2], (1,), minval=-np.pi, maxval=np.pi)]))
        dp = jax.random.normal(ks[3], (3,)) * cfg.trans_sigma
        rv_d = jax.random.normal(ks[4], (3,)) * cfg.rot_sigma
        kp, kd, kg, kn1, kn2, _ = jax.random.split(ks[9], 6)
        params = jfx.draw_params(kp, jfx.EffectsConfig())
        drift = 1.0 + jax.random.normal(kg) * jfx.EffectsConfig().gain_drift
        noise = jnp.stack([jnp.stack([jax.random.normal(k2, hw).reshape(-1)[:n_noise]
                                      for k2 in jax.random.split(kn)]) for kn in (kn1, kn2)])
        return dict(
            p1=p1, q1=q1, p2=p1 + dp, q2=quat_mul(q1, quat_exp(rv_d)), dp=dp, rv_d=rv_d,
            tex_idx=tex_indices[jax.random.randint(ks[5], (), 0, tex_indices.shape[0])],
            tex_params=jtex.random_tex_params(ks[7], cfg.tex_scale_range),
            exposure_frac=jax.random.uniform(ks[8], maxval=cfg.exposure_frac_max),
            params1=params,
            params2=params.at[1].multiply(jnp.where(params[1] == 1.0, 1.0, drift)),
            sigma=jax.random.uniform(kd, maxval=jfx.EffectsConfig().defocus_sigma_max)
            * (params[1] != 1.0),
            prior_sigma=jnp.exp(jax.random.uniform(
                ks[10], minval=jnp.log(cfg.prior_noise_lo), maxval=jnp.log(cfg.prior_noise_px))),
            prior_noise=jax.random.normal(ks[6], (4, 2)), noise=noise)

    rows = [one(k) for k in jnp.asarray(keys)]
    out = {k: np.stack([np.asarray(r[k]) for r in rows]) for k in rows[0]}
    out["noise"] = np.moveaxis(out["noise"], 0, 2)  # (2 frames, 2 kinds, B, n)
    return out


def jax_window_draws(keys, cfg, tex_indices, n_noise: int) -> dict:
    """The JAX ``window_loss``'s draws of each window key, named as the
    port's ``WindowDraws`` (the normals before their scale), and the first
    ``n_noise`` values of each frame's read and shot noise image, (2, B,
    W + 1, n_noise)."""
    import jax
    import jax.numpy as jnp

    from cuahn_vio.data import sensor_effects as jfx
    from cuahn_vio.data import textures as jtex

    w, t = cfg.window, cfg.imu_substeps

    def one(k):
        ks = jax.random.split(k, 10)
        ik = jax.random.split(ks[8], 5)
        noise = jnp.stack([jnp.stack([jax.random.normal(k2, tuple(cfg.img_hw)).reshape(-1)[
            :n_noise] for k2 in jax.random.split(fk)]) for fk in jax.random.split(ks[3], w + 1)])
        return dict(
            tex_idx=tex_indices[jax.random.randint(ks[0], (), 0, tex_indices.shape[0])],
            tex_params=jtex.random_tex_params(ks[1], cfg.tex_scale_range),
            lens=jfx.draw_params(ks[2], jfx.EffectsConfig()),
            frame_noise=jnp.moveaxis(noise, 1, 0),  # (2, W + 1, n)
            bias_g=jax.random.normal(ks[4], (3,)), bias_a=jax.random.normal(ks[5], (3,)),
            noise_w=jax.random.normal(ks[6], (w, t, 3)),
            noise_a=jax.random.normal(ks[7], (w, t, 3)),
            init_tilt=jax.random.normal(ik[0], (2,)), init_p=jax.random.normal(ik[1], (3,)),
            init_v=jax.random.normal(ik[2], (3,)), init_ba=jax.random.normal(ik[3], (3,)),
            init_bg=jax.random.normal(ik[4], (3,)))

    rows = [one(k) for k in jnp.asarray(keys)]
    out = {k: np.stack([np.asarray(r[k]) for r in rows]) for k in rows[0]}
    out["frame_noise"] = np.moveaxis(out["frame_noise"], 0, 1)  # (2, B, W + 1, n)
    return out


def train_reference() -> None:
    import dataclasses
    import inspect

    import chip_smoke
    import jax

    from cuahn_vio.data import textures as jtex
    from cuahn_vio.train import fil as jfil
    from cuahn_vio.train import trainer as jtrain
    from cuahn_vio_torch import cli
    from cuahn_vio_torch.train.trainer import PROBE_SEED, PROBE_SIZE

    n_bank = chip_smoke.CARD_TEXTURES
    hw = (chip_smoke.H, chip_smoke.W)
    port_cfg = cli.train_config(cli.build_parser().parse_args(
        ["train-uahn", "--batch-size", str(chip_smoke.TRAIN_BATCH)]))
    cfg = jtrain.TrainConfig(**dataclasses.asdict(port_cfg))
    n = chip_smoke.DRAW_NOISE_VALUES
    _, kb, ks = jax.random.split(jax.random.PRNGKey(0), 3)
    out = {f"step0_{k}": v for k, v in jax_pair_draws(
        jax.random.split(kb, cfg.batch_size), cfg, np.asarray(jtex.train_indices(n_bank)),
        n, hw).items()}
    jax_seed = inspect.signature(jtrain.make_probe_metric).parameters["probe_seed"].default
    assert jax_seed == PROBE_SEED
    probe = jax_pair_draws(jax.random.split(jax.random.PRNGKey(PROBE_SEED), PROBE_SIZE), cfg,
                           np.asarray(jtex.heldout_indices(n_bank)), n, hw)
    out.update({f"probe_{k}": v for k, v in probe.items()})
    fcfg = jfil.FilConfig(window=chip_smoke.FIL_WINDOW, batch_size=chip_smoke.FIL_BATCH)
    fil = jax_window_draws(jax.random.split(ks, fcfg.batch_size), fcfg,
                           np.asarray(jtex.train_indices(n_bank)), n)
    out.update({f"fil_{k}": v for k, v in fil.items()})
    path = os.path.join(REPO, chip_smoke.TRAIN_DRAWS)
    np.savez_compressed(path, **out)
    print(f"train: wrote {path} ({os.path.getsize(path)} bytes, {len(out)} arrays)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--part", choices=["single", "batch", "bf16", "raw", "loop", "diag",
                                       "tune", "prng", "train", "both"],
                    default="both")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke
    from cuahn_vio_torch.data.synthetic import AnalyticTrajectory, make_sequence
    from cuahn_vio_torch.utils.config import VioOptions

    os.makedirs(args.out_dir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    if args.part == "prng":
        prng_reference()
        return 0
    if args.part == "train":
        train_reference()
        return 0
    if args.part == "raw":
        raw(env, args.out_dir, chip_smoke.WEIGHTS)
        return 0
    if args.part == "loop":
        loop(env, args.out_dir, chip_smoke.WEIGHTS)
        return 0
    if args.part == "diag":
        diag(env, args.out_dir, chip_smoke.WEIGHTS)
        return 0
    opts = VioOptions.uzhfpv_indoor45().apply_profile("calibrated")
    seq = make_sequence(AnalyticTrajectory(), np.asarray(opts.t_imu_to_cam),
                        device="cpu", **chip_smoke.SEQ)
    write_sequence(args.out_dir, "seq", seq)
    opts.calib_camimu_dt = 0.0
    opts.init_height = float(seq.gt_pose_w[0, 2])
    opts.init_imu_thresh = 0.2
    opts.to_yaml(os.path.join(args.out_dir, "seq_config.yaml"))

    if args.part in ("single", "both"):
        single(env, args.out_dir, chip_smoke.WEIGHTS)
    if args.part == "bf16":
        bf16(env, args.out_dir, chip_smoke.WEIGHTS)
    if args.part == "tune":
        tune(env, args.out_dir, chip_smoke.WEIGHTS)
    if args.part in ("batch", "both"):
        stems = ["seq"]
        for i, tex_seq in enumerate(chip_smoke.textured_sequences("cpu")):
            write_sequence(args.out_dir, f"tex{i}", tex_seq)
            stems.append(f"tex{i}")
        batch(env, args.out_dir, chip_smoke.WEIGHTS, stems)
    return 0


if __name__ == "__main__":
    sys.exit(main())
