"""Command line of the port: ``python -m cuahn_vio_torch.cli VERB ...``.

Each verb takes the same files, flags and outputs as the JAX CLI's verb
(``python -m cuahn_vio.cli``). The VIO verbs run on the card (``--device
cuda``, the default; they fail when no GPU is found):

- ``run-vio``: one sequence through ``run_offline``, or frame by frame
  through ``run_stepwise`` with ``--timing-out`` (the per-stage timing
  csv and the divergence guard); ``--bf16`` (bfloat16 conv towers),
  ``--cov-calib`` (reported-covariance inflation), ``--state-out`` and
  ``--odom-out`` (FRD odometry);
- ``run-vio-batch``: many sequences in lockstep on one card
  (``run_offline_batch``), one pose file per input; ``--mesh`` shards them
  over the job's devices (one process: the one card, the same files);
- ``make-synthetic``: a synthetic sequence (procedural or photo-texture
  ground, sharp or motion-blurred, with or without the sensor-effect
  chain), written as ``.npz``, ``_gt.txt``, ``_state_gt.txt`` and
  ``_config.yaml``;
- ``train-uahn``: trains UAHN weights (``train.trainer.train``) on
  rendered pairs, from a Flax checkpoint (``--resume``) or from scratch,
  and writes Flax checkpoints the JAX package reads;
- the raw-camera chain: ``distort-to-euroc`` re-projects a rendered
  ``.npz`` out to the config's raw distorted camera as a EuRoC-ASL
  directory of PNGs, and ``convert-euroc`` reads a EuRoC-ASL directory
  back (the port's own PNG codec), undistorts every frame into the
  224x320 virtual camera (one launch of the remap kernel C1 on the card)
  and writes the ``.npz`` that ``run-vio`` reads. ``make-synthetic
  --traj-file`` flies a recorded pose file (``data/bspline``);
- the measurement diagnostics: ``eval-flow`` (the network on every frame
  pair of a rendered sequence against the oracle flow of its GT poses,
  errors and z-scores, with no filter in the loop), ``inspect-frame``
  (one pair through blocks 1-4 with the photometric error map, written
  beside the two frames as one greyscale PNG) and ``track-features``
  (grid-detected Shi-Tomasi corners tracked by pyramidal KLT, dead slots
  re-detected);
- the sweep and the parallel layer: ``tune-filter`` (the filter replayed
  over a ``run-vio --state-out`` log for a whole grid of filter parameters
  at once, ``eval/tuning``; it warns on stderr that the open-loop replay
  diverges at v10's quality), ``smooth-trajectory --mesh`` (the
  block-partitioned Schur solve, ``parallel/pose_graph_sharded``; refused
  with ``--huber``) and ``distributed-selftest`` (the deterministic
  sharded workload over ``torch.distributed``: one process on the card,
  or N processes on the CPU with ``--device cpu``, gloo).

The eval verbs score those outputs on the host (numpy only):
``error-singlerun`` (ATE / RPE / NEES of a pose file against GT),
``timing-percentages`` (the timing csv's stage split),
``error-simulation`` (state errors and NEES of a ``--state-out`` npz
against the simulator GT), ``format-converter`` (EuRoC csv <-> pose
txt), and the covariance fits ``calibrate-covariance`` (the network
covariance's temperature k_net_cov from a ``--state-out`` log's
innovations) and ``calibrate-state-covariance`` (the ``--cov-calib``
factors from a log against its state GT; a log already inflated by
``--cov-calib`` is refused), ``error-dataset`` / ``error-comparison``
(ATE of many runs), ``align-trajectory`` (GT aligned onto an estimate),
``timing-comparison`` (stage statistics of several timing csvs) and
``pid-monitor`` (CPU % and RSS of a process, from ``/proc``). The plot
verbs draw the JAX verbs' figures (``eval/plots``) with the port's own
raster writer: ``plot-trajectories``, ``plot-trackhist``,
``timing-flamegraph``, ``watch-run`` (a live xy plot of a growing
estimate) and ``error-simulation --plot``. No verb needs PyYAML, PIL,
psutil or matplotlib: configs go through the port's own
``utils.yaml_io``, PNGs through ``utils.png``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

def _device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device found; pass --device cpu to run on the CPU")
    return device


def _model(opts, weights, device, bf16: bool = False):
    """The UAHN with ``weights``; without them, the JAX verbs' random one,
    ``init_uahn(PRNGKey(0))`` (which loading weights would overwrite
    leaf for leaf). Built with ``opts.mc_dropout`` (the JAX CLI always uses
    the UAHN default, 0.05); ``bf16``: bfloat16 conv towers."""
    import torch

    from cuahn_vio_torch.models.uahn import build_uahn, init_uahn
    from cuahn_vio_torch.utils import prng
    from cuahn_vio_torch.utils.checkpoint import load_params

    kw = dict(device=device, dropout_rate=opts.mc_dropout, blocks_to_run=opts.blocks_to_run,
              compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    if weights:
        return build_uahn(load_params(weights), **kw)
    return init_uahn(prng.prng_key(0), **kw)


def _initial_uahn(seed: int, weights, device):
    """The trainers' starting UAHN: ``weights`` (``--resume``) where given,
    else the JAX trainers' ``init_uahn(PRNGKey(seed))`` (which the JAX verbs
    then overwrite leaf for leaf with ``--resume``)."""
    from cuahn_vio_torch.models.uahn import build_uahn, init_uahn
    from cuahn_vio_torch.utils import prng
    from cuahn_vio_torch.utils.checkpoint import load_params

    if weights:
        return build_uahn(load_params(weights), device=device)
    return init_uahn(prng.prng_key(seed), device=device)


def _cov_factors(text: str) -> dict:
    """``pos:2,ori:3`` -> {"pos": 2.0, "ori": 3.0}; a block name outside
    ``COV_BLOCKS`` is refused (the JAX verb ignores it)."""
    from cuahn_vio_torch.eval.calibration import COV_BLOCKS

    factors = {k: float(v) for k, v in (kv.split(":") for kv in text.split(","))}
    unknown = sorted(set(factors) - set(COV_BLOCKS))
    if unknown:
        raise SystemExit(f"--cov-calib: unknown blocks {unknown} (of {list(COV_BLOCKS)})")
    return factors


def _load_sequence(path: str):
    if not path.endswith(".npz"):
        raise SystemExit(
            "expected an .npz sequence file with imu_t/imu_w/imu_a/cam_t/frames"
        )
    d = np.load(path)
    return d["imu_t"], d["imu_w"], d["imu_a"], d["cam_t"], d["frames"]


def _options(args):
    from cuahn_vio_torch.utils.config import VioOptions

    opts = VioOptions.from_yaml(args.config) if args.config else VioOptions.uzhfpv_indoor45()
    # an explicit --profile always applies; a bare invocation gets the
    # calibrated operating point; a user --config is honored as-is
    if args.profile is not None:
        opts = opts.apply_profile(args.profile)
    elif not args.config:
        opts = opts.apply_profile("calibrated")
    overrides = {
        "init_height": "init_height",
        "init_imu_thresh": "init_imu_thresh",
        "calib_dt": "calib_camimu_dt",
        "k_net_cov": "up_linear_k_hnet_cov",
        "chi2_gate": "chi2_gate",
        "iekf": "max_iekf_iterations",
        "q_scale": "process_noise_scale",
        "q_pos_extra": "extra_position_noise",
        "bias_sigma_px": "meas_bias_sigma_px",
        "bias_tau": "meas_bias_tau",
        "chi2_soft": "chi2_soft",
        "echo_beta": "echo_beta",
    }
    for arg, field in overrides.items():
        value = getattr(args, arg)
        if value is not None:
            setattr(opts, field, value)
    if args.no_prior:
        opts.use_prior = False
    return opts


def cmd_run_vio(args):
    from cuahn_vio_torch.eval.traj_io import save_pose_file, save_timing_file
    from cuahn_vio_torch.pipeline.runner import run_offline, run_stepwise

    device = _device(args.device)
    opts = _options(args)
    factors = _cov_factors(args.cov_calib) if args.cov_calib else None
    seq = _load_sequence(args.sequence)
    model = None
    if not args.no_network:
        model = _model(opts, args.weights or opts.network_weights_path, device, args.bf16)
    runner = run_stepwise if args.timing_out else run_offline
    res = runner(
        *seq, model, opts.filter_params(device), opts.vio_config(),
        opts.runner_options(), seed=args.seed, device=device,
    )
    calib = {}  # the npz of --state-out records the factors applied
    if factors is not None:
        # reported-covariance calibration: scales the output covariance
        # only; the filter's gains are untouched
        from cuahn_vio_torch.eval.calibration import COV_BLOCKS, apply_cov_inflation

        calib = dict(cov_calib_blocks=np.array(COV_BLOCKS), cov_calib_factors=np.array(
            [factors.get(name, 1.0) for name in COV_BLOCKS]))
        cal = apply_cov_inflation(res.cov_core, factors)
        res = res._replace(
            cov_core=cal,
            cov_diag=np.einsum("fii->fi", cal).copy(),
            cov_ori=cal[:, 3:6, 3:6],
            cov_pos=cal[:, 0:3, 0:3],
        )
        print(f"applied reported-covariance calibration: {factors}")

    save_pose_file(args.out, res.times, res.pose_w, res.cov_ori, res.cov_pos)
    print(f"wrote {len(res.times)} poses -> {args.out}")
    if args.timing_out and res.stage_ms is not None:
        save_timing_file(args.timing_out, res.times, res.stage_ms)
        print(f"wrote timing -> {args.timing_out}")
    if args.state_out:
        np.savez_compressed(
            args.state_out,
            times=res.times, pose=res.pose_w, v_body=res.v_body,
            ba=res.ba, bg=res.bg, cov_diag=res.cov_diag,
            cov_core=res.cov_core,
            net_chi2=res.net_chi2, net_inno=res.net_inno,
            cov_meas=res.cov_meas, net_cov88=res.net_cov88,
            net_mean=res.net_mean, **calib,
        )
        print(f"wrote full state -> {args.state_out}")
    if args.odom_out:
        from cuahn_vio_torch.eval.traj_io import save_odom_file

        save_odom_file(args.odom_out, res.times, res.pose_w, res.v_body)
        print(f"wrote odometry -> {args.odom_out}")
    if res.n_recoveries:
        print(f"divergence guard fired {res.n_recoveries}x (state rolled back)")
    if model is not None:
        finite = np.isfinite(res.net_chi2)
        rejected = int((res.net_chi2 >= opts.chi2_gate).sum()) + int((~finite).sum())
        if finite.any():
            chi2 = res.net_chi2[finite]
            print(
                "innovation chi2 (8 DoF): median "
                f"{np.median(chi2):.1f}, p95 {np.percentile(chi2, 95):.1f}; "
                f"{rejected} of {len(res.net_chi2)} measurements gated out"
            )


def cmd_run_vio_batch(args):
    """Many sequences in lockstep on one card; one pose txt per input."""
    import os

    from cuahn_vio_torch.eval.traj_io import save_pose_file
    from cuahn_vio_torch.pipeline.runner import run_offline_batch
    from cuahn_vio_torch.utils.config import VioOptions

    device = _device(args.device)
    if args.mesh:  # a job's rank binds its own card before any tensor is made
        from cuahn_vio_torch.parallel.mesh import init_distributed

        init_distributed(device=device)
    opts = VioOptions.from_yaml(args.config) if args.config else VioOptions.uzhfpv_indoor45()
    # the same profile resolution as run-vio
    if args.profile is not None:
        opts = opts.apply_profile(args.profile)
    elif not args.config:
        opts = opts.apply_profile("calibrated")
    if args.init_height is not None:
        opts.init_height = args.init_height
    # the config's weights when --weights is not given, as run-vio does
    # (the JAX verb reads only --weights)
    model = (None if args.no_network
             else _model(opts, args.weights or opts.network_weights_path, device))
    mesh, paths = None, args.sequences
    if args.mesh:
        import math

        from cuahn_vio_torch.parallel.mesh import make_mesh, shard_bounds

        # as the JAX verb: the largest mesh that splits the sequences evenly
        n_dev = math.gcd(len(args.sequences), make_mesh(device).size)
        mesh = make_mesh(device, n_devices=n_dev)
        lo, hi = shard_bounds(len(args.sequences), mesh)
        paths = args.sequences[lo:hi]
        print(f"sharding {len(args.sequences)} sequences over {n_dev} devices")
    results = run_offline_batch(
        [_load_sequence(path) for path in args.sequences], model,
        opts.filter_params(device), opts.vio_config(), opts.runner_options(),
        seed=args.seed, device=device, mesh=mesh,
    )
    os.makedirs(args.out_dir, exist_ok=True)
    for path, res in zip(paths, results):
        name = os.path.splitext(os.path.basename(path))[0] + ".txt"
        dst = os.path.join(args.out_dir, name)
        save_pose_file(dst, res.times, res.pose_w, res.cov_ori, res.cov_pos)
        print(f"{path}: {len(res.times)} frames -> {dst}")


def cmd_make_synthetic(args):
    import os

    from cuahn_vio_torch.data.synthetic import AnalyticTrajectory, make_sequence
    from cuahn_vio_torch.eval.simulation import StateGT, save_state_gt
    from cuahn_vio_torch.eval.traj_io import save_pose_file
    from cuahn_vio_torch.utils.config import VioOptions

    device = _device(args.device)
    # the written _config.yaml records the operating point: a bare
    # invocation bakes the calibrated profile in, a user --config passes
    # through untouched
    opts = (
        VioOptions.from_yaml(args.config) if args.config
        else VioOptions.uzhfpv_indoor45().apply_profile("calibrated")
    )
    effects = None
    if args.effects:
        from cuahn_vio_torch.data.sensor_effects import EffectsConfig

        effects = EffectsConfig()
    texture = tex_params = None
    if args.texture != "none":
        from cuahn_vio_torch.data.textures import (
            default_tex_params,
            get_texture_bank,
            heldout_indices,
            train_indices,
        )

        bank = get_texture_bank()
        split = (
            heldout_indices(len(bank)) if args.texture == "heldout"
            else train_indices(len(bank))
        )
        pick = args.texture_pick if args.texture_pick is not None else args.seed
        idx = int(split[pick % len(split)])
        texture = bank[idx]
        tex_params = default_tex_params(args.tex_scale)
        print(f"ground texture: bank[{idx}] of {len(bank)} ({args.texture} split), "
              f"{args.tex_scale} m/period")
    if args.traj_file:
        from cuahn_vio_torch.data.bspline import SplineTrajectory

        traj = SplineTrajectory.from_trajectory_file(
            args.traj_file, dt=args.spline_dt, z_offset=args.traj_z_offset)
    else:
        traj = AnalyticTrajectory()
    seq = make_sequence(
        traj, np.asarray(opts.t_imu_to_cam),
        duration=args.duration, seed=args.seed,
        sigma_w=args.sigma_w, sigma_a=args.sigma_a,
        bias_g=args.bias_g, bias_a=args.bias_a, texture_seed=args.seed,
        texture=texture, tex_params=tex_params, exposure_s=args.exposure_ms * 1e-3,
        effects=effects, effects_seed=args.seed, device=device,
    )
    np.savez_compressed(
        args.out, imu_t=seq.imu_t, imu_w=seq.imu_w, imu_a=seq.imu_a,
        cam_t=seq.cam_t, frames=seq.frames,
    )
    stem = os.path.splitext(args.out)[0]
    save_pose_file(stem + "_gt.txt", seq.gt_times, seq.gt_pose_w)
    n = len(seq.gt_times)
    save_state_gt(stem + "_state_gt.txt", StateGT(
        times=seq.gt_times, pose=seq.gt_pose_w, vel=seq.gt_vel_w,
        bg=np.tile(seq.true_bg, (n, 1)), ba=np.tile(seq.true_ba, (n, 1)),
    ))
    # a config whose init/calib knobs match this sequence (no cam-imu time
    # offset; hover altitude as init_height; gentle motion-onset jerk)
    opts.calib_camimu_dt = 0.0
    opts.init_height = float(seq.gt_pose_w[0, 2])
    opts.init_imu_thresh = 0.2
    opts.to_yaml(stem + "_config.yaml")
    print(f"wrote {args.out}, {stem}_gt.txt, {stem}_state_gt.txt and "
          f"{stem}_config.yaml")


def _camera_options(config):
    from cuahn_vio_torch.utils.config import VioOptions

    return VioOptions.from_yaml(config) if config else VioOptions.uzhfpv_indoor45()


def cmd_convert_euroc(args):
    """EuRoC-ASL dir -> preprocessed .npz, undistorted on ``--device`` (the
    camera parameters come from the config)."""
    from cuahn_vio_torch.data.euroc import load_euroc_sequence, save_sequence_npz

    device = _device(args.device)
    opts = _camera_options(args.config)
    seq = load_euroc_sequence(
        args.root, np.asarray(opts.cam_intrinsics, np.float64),
        np.asarray(opts.cam_distortion, np.float64), opts.cam_is_fisheye,
        max_frames=args.max_frames, device=device,
    )
    save_sequence_npz(args.out, seq)
    print(f"wrote {args.out}: {len(seq.cam_t)} frames, {len(seq.imu_t)} imu samples")


def cmd_distort_to_euroc(args):
    """Rendered .npz sequence -> RAW distorted EuRoC-ASL directory: the
    virtual-camera (f = 159.5 pinhole) frames warped out to the config's
    raw camera. Chained with ``convert-euroc`` + ``run-vio``, this drives
    the whole raw-camera ingestion path on synthetic imagery."""
    from cuahn_vio_torch.data.euroc import distort_frames_to_raw, write_euroc_dir

    device = _device(args.device)
    opts = _camera_options(args.config)
    d = np.load(args.sequence)
    raw = distort_frames_to_raw(
        d["frames"], list(opts.cam_intrinsics), list(opts.cam_distortion),
        opts.cam_is_fisheye, raw_w=opts.cam_width, raw_h=opts.cam_height, device=device,
    )
    write_euroc_dir(args.out, raw, d["imu_t"], d["imu_w"], d["imu_a"], d["cam_t"])
    print(f"wrote EuRoC dir {args.out}: {len(d['cam_t'])} raw "
          f"{opts.cam_width}x{opts.cam_height} frames")


def cmd_format_converter(args):
    """EuRoC ground-truth csv <-> pose txt, by the input's extension."""
    from cuahn_vio_torch.eval.traj_io import (
        load_euroc_csv,
        load_pose_file,
        save_euroc_csv,
        save_pose_file,
    )

    if args.input.endswith(".csv"):
        traj = load_euroc_csv(args.input)
        save_pose_file(args.output, traj.times, traj.poses)
    else:
        save_euroc_csv(args.output, load_pose_file(args.input))
    print(f"converted {args.input} -> {args.output}")


def cmd_train_uahn(args):
    """Train UAHN weights (``train.trainer.train``). Launched as a job
    (``python -m torch.distributed.run --nproc-per-node N -m
    cuahn_vio_torch.cli train-uahn ...``: torch's environment names the
    ranks), each rank takes its own card and the job trains data-parallel;
    rank 0 alone prints and writes. Without such a job, one process."""
    import torch.distributed as dist

    from cuahn_vio_torch.parallel.mesh import init_distributed, world

    device = _device(args.device)
    init_distributed(device=device)  # a no-op outside a job
    try:
        _train_uahn(args, device, world()[1] == 0)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def train_config(args):
    """``train-uahn``'s ``TrainConfig`` of its parsed arguments."""
    from cuahn_vio_torch.train import TrainConfig

    return TrainConfig(
        batch_size=args.batch_size, lr=args.lr,
        trans_sigma=args.trans_sigma, rot_sigma=args.rot_sigma,
        prior_noise_lo=args.prior_noise_lo,
        prior_noise_px=args.prior_noise_px,
        height_range=(args.height_min, args.height_max),
        tilt_sigma=args.tilt_sigma,
        use_textures=not args.no_textures,
        use_effects=not args.no_effects,
        exposure_frac_max=args.exposure_frac_max,
        max_flow_px=args.max_flow_px,
        echo_weight=args.echo_weight,
        big_baseline_prob=args.big_baseline_prob,
        traj_pair_prob=args.traj_pair_prob,
    )


def _train_uahn(args, device, lead: bool):
    import torch

    from cuahn_vio_torch.train import train
    from cuahn_vio_torch.utils.checkpoint import save_params
    from cuahn_vio_torch.utils.config import VioOptions

    opts = VioOptions.from_yaml(args.config) if args.config else VioOptions.uzhfpv_indoor45()
    model = _initial_uahn(args.seed, args.resume, device)
    if args.resume and lead:
        print(f"resumed from {args.resume}")
    t = np.asarray(opts.t_imu_to_cam, np.float64)
    c_rot_i = torch.tensor(t[:3, :3], dtype=torch.float32, device=device)
    i_t_i2c = torch.tensor(-t[:3, :3].T @ t[:3, 3], dtype=torch.float32, device=device)
    train(
        model, c_rot_i, i_t_i2c, train_config(args),
        steps=args.steps, seed=args.seed,
        checkpoint_path=args.out, save_every=args.save_every,
    )
    if lead:
        save_params(args.out, model.state_dict())
        print(f"wrote weights -> {args.out}")


def cmd_close_loops(args):
    """Detect overlap candidates in a run, re-run the UAHN across each
    long-baseline pair on ``--device``, and write relative-position loop
    factors for smooth-trajectory (``pipeline/loop_closure``)."""
    from cuahn_vio_torch.models.uahn import build_uahn
    from cuahn_vio_torch.ops.homography import f32_parity_mode
    from cuahn_vio_torch.pipeline.loop_closure import (
        LOOP_BATCH,
        find_loop_candidates,
        generate_loop_factors,
    )
    from cuahn_vio_torch.utils.checkpoint import load_params
    from cuahn_vio_torch.utils.config import VioOptions

    device = _device(args.device)
    f32_parity_mode()
    opts = VioOptions.from_yaml(args.config) if args.config else VioOptions.uzhfpv_indoor45()
    seq = np.load(args.sequence)
    st = np.load(args.state)
    pose = st["pose"]
    p_w = pose[:, :3]
    q = pose[:, [6, 3, 4, 5]]  # file xyzw -> wxyz

    # map state rows onto camera frames (the state starts at the 2nd frame)
    times = st["times"]
    cam_t = seq["cam_t"]
    frame_of = np.clip(np.searchsorted(cam_t + opts.calib_camimu_dt, times), 0, len(cam_t) - 1)

    pairs = find_loop_candidates(times, p_w, min_dt=args.min_dt, max_dist=args.max_dist,
                                 stride=args.stride, max_pairs=args.max_pairs)
    if len(pairs) == 0:
        raise SystemExit("no loop candidates found")
    print(f"{len(pairs)} loop candidates")

    # the JAX verb's UAHN: init_uahn's defaults (dropout 0.05, blocks 3)
    model = build_uahn(load_params(args.weights), device=device)
    t = np.asarray(opts.t_imu_to_cam)
    c_rot_i = t[:3, :3]
    i_t_i2c = -t[:3, :3].T @ t[:3, 3]
    lf = generate_loop_factors(
        seq["frames"][frame_of], times, p_w, q, c_rot_i, i_t_i2c, model, pairs=pairs,
        max_sigma_px=args.max_sigma_px, max_prior_px=args.max_prior_px,
    )
    print(f"{lf.inferred} of {len(pairs)} candidates inside the geometric gate (predicted "
          f"flow <= {args.max_prior_px} px): the network ran on them in "
          f"{-(-lf.inferred // LOOP_BATCH)} batches of <= {LOOP_BATCH}")
    with open(args.out, "w") as f:
        f.write("# i j dpx dpy dpz dqw dqx dqy dqz sigma_p\n")
        for k in range(len(lf.pairs)):
            row = [*lf.pairs[k], *lf.dp_meas[k], *lf.dq_meas[k], lf.sigma_p[k]]
            f.write(" ".join(str(v) for v in row) + "\n")
    print(
        f"wrote {len(lf.pairs)} loop factors -> {args.out} "
        f"({len(pairs) - len(lf.pairs)} of {len(pairs)} candidates gated "
        "out by network confidence)"
    )


def smoothing_graph(args, device):
    """(trajectory, pose graph) of a ``smooth-trajectory`` ARGS on
    ``device``: chain factors from the odometry in ``args.est``, loop
    factors from ``--loops-file`` (column 10, scaled by
    ``--loop-sigma-scale``, as per-factor sigmas unless ``--loop-sigma-dp``
    is given) or between the keyframe pairs of ``--loops``."""
    import torch

    from cuahn_vio_torch.eval.traj_io import load_pose_file
    from cuahn_vio_torch.parallel.pose_graph import chain_graph_from_trajectory, relative_pose

    traj = load_pose_file(args.est)
    # file poses are [x y z qx qy qz qw]; the module wants wxyz
    p = torch.tensor(traj.poses[:, :3], dtype=torch.float32, device=device)
    q = torch.tensor(traj.poses[:, [6, 3, 4, 5]], dtype=torch.float32, device=device)

    pairs, edp, edq = None, None, None
    loop_sigma_dp = args.loop_sigma_dp
    if args.loops_file:
        rows = np.loadtxt(args.loops_file, comments="#")
        rows = rows.reshape(-1, rows.shape[-1] if rows.ndim > 1 else 10)
        if rows.shape[0] == 0:
            print("loops file has no factors; chain-only smoothing")
        else:
            pairs = [(int(a), int(b)) for a, b in rows[:, :2]]
            edp = rows[:, 2:5].astype(np.float32)
            edq = rows[:, 5:9].astype(np.float32)
            if rows.shape[1] >= 10 and loop_sigma_dp is None:
                # per-factor sigmas from the network covariance (col 10),
                # scaled by --loop-sigma-scale (the network covariance is
                # optimistic, so the calibrated scale is > 1)
                loop_sigma_dp = (rows[:, 9] * args.loop_sigma_scale).astype(np.float32)
    elif args.loops:
        pairs = [tuple(int(x) for x in pair.split(":")) for pair in args.loops.split(",")]
        a, b = (torch.tensor(k, device=device) for k in zip(*pairs))
        edp, edq = relative_pose(p[a], q[a], p[b], q[b])
    graph = chain_graph_from_trajectory(
        p, q, sigma_dp=args.sigma_dp, sigma_dth=args.sigma_dth,
        extra_pairs=pairs, extra_dp=edp, extra_dq=edq,
        extra_sigma_dp=loop_sigma_dp, extra_sigma_dth=args.loop_sigma_dth,
    )
    return traj, graph


def cmd_smooth_trajectory(args):
    """Pose-graph smoothing of a VIO estimate on ``--device``: chain
    factors from the odometry, optional loop factors from a close-loops
    file or between keyframe pairs given as 'a:b,a:b,...'
    (``smoothing_graph``, ``parallel/pose_graph``). ``--mesh`` runs the
    block-partitioned Schur solve (``parallel/pose_graph_sharded``), one
    block per device of the job's mesh; it has no robust kernel, so the
    pair ``--mesh --huber`` is refused (the JAX verb drops ``--huber``)."""
    from cuahn_vio_torch.eval.traj_io import save_pose_file
    from cuahn_vio_torch.ops.homography import f32_parity_mode
    from cuahn_vio_torch.parallel.pose_graph import optimize

    if args.mesh and args.huber > 0:
        raise SystemExit(
            "smooth-trajectory: --mesh runs the Schur solve, which has no robust "
            f"kernel; --huber {args.huber:g} cannot apply (the JAX verb drops it "
            "silently): drop --mesh or --huber")
    device = _device(args.device)
    if args.mesh:  # a job's rank binds its own card before any tensor is made
        from cuahn_vio_torch.parallel.mesh import init_distributed

        init_distributed(device=device)
    f32_parity_mode()
    traj, graph = smoothing_graph(args, device)
    if args.mesh:
        from cuahn_vio_torch.parallel.mesh import make_mesh
        from cuahn_vio_torch.parallel.pose_graph_sharded import (
            optimize_sharded,
            partition_graph,
            reassemble,
        )

        mesh = make_mesh(device)
        sg = partition_graph(graph, mesh.size)
        p_int, q_int, p_sep, q_sep, costs = optimize_sharded(sg, mesh, iters=args.iters)
        p_opt, q_opt = reassemble(sg, p_int, q_int, p_sep, q_sep, mesh)
        print(f"sharded GN over {mesh.size} devices")
    else:
        p_opt, q_opt, costs = optimize(graph, iters=args.iters, huber_delta=args.huber)
        p_opt, q_opt = p_opt.cpu().numpy(), q_opt.cpu().numpy()
    print(f"cost {float(costs[0]):.4g} -> {float(costs[-1]):.4g}")
    poses = np.concatenate([p_opt, q_opt[:, [1, 2, 3, 0]]], axis=1)
    save_pose_file(args.out, traj.times, poses)
    print(f"wrote {args.out}")


def cmd_train_fil(args):
    """Filter-in-the-loop fine-tune from ``--resume`` on ``--device``
    (``train.fil.fil_finetune``): windows of the UZH-FPV training
    trajectories in ``data.trajpairs.GT_DIR``; refuses when it holds none."""
    import torch

    from cuahn_vio_torch.data.trajpairs import GT_DIR, train_trajectory_files
    from cuahn_vio_torch.train.fil import FilConfig, fil_finetune
    from cuahn_vio_torch.utils.checkpoint import save_params
    from cuahn_vio_torch.utils.config import VioOptions

    device = _device(args.device)
    if not train_trajectory_files(GT_DIR):
        raise SystemExit(
            f"train-fil: no training trajectory in {GT_DIR}: its windows are cut from "
            "*_with_gt.txt ground-truth files (the UZH-FPV GT, less the benchmark "
            "replays); put them there")
    opts = (
        VioOptions.from_yaml(args.config) if args.config
        else VioOptions.uzhfpv_indoor45().apply_profile("calibrated")
    )
    model = _initial_uahn(args.seed, args.resume, device)
    print(f"resumed from {args.resume}")
    t = np.asarray(opts.t_imu_to_cam, np.float64)
    c_rot_i = torch.tensor(t[:3, :3], dtype=torch.float32, device=device)
    i_t_i2c = torch.tensor(-t[:3, :3].T @ t[:3, 3], dtype=torch.float32, device=device)
    fil_finetune(
        model, opts.filter_params(device), c_rot_i, i_t_i2c,
        FilConfig(window=args.window, batch_size=args.batch_size, w_cons=args.w_cons),
        steps=args.steps, lr=args.lr, seed=args.seed, checkpoint_path=args.out,
        save_every=args.save_every, pair_step_every=args.pair_step_every, gt_dir=GT_DIR,
    )
    save_params(args.out, model.state_dict())
    print(f"wrote weights -> {args.out}")


def cmd_error_singlerun(args):
    from cuahn_vio_torch.eval.metrics import ResultTrajectory

    rt = ResultTrajectory.from_files(args.est, args.gt, args.align)
    length = rt.trajectory_length()
    print(f"[COMP]: {len(rt.times)} matched poses, {length:.3f} m trajectory")

    ori, pos = rt.calculate_ate()
    print("=" * 60)
    print("Absolute Trajectory Error (ATE)")
    print(f"  ori: rmse {ori.rmse:.5f} deg | mean {ori.mean:.5f} | std {ori.std:.5f}")
    print(f"  pos: rmse {pos.rmse:.5f} m   | mean {pos.mean:.5f} | std {pos.std:.5f}")

    ori2, pos2 = rt.calculate_ate_2d()
    print("ATE 2D")
    print(f"  yaw: rmse {ori2.rmse:.5f} deg | pos-xy: rmse {pos2.rmse:.5f} m")

    segments = [float(x) for x in args.segments.split(",")] if args.segments else [
        length * f for f in (0.1, 0.2, 0.3, 0.4, 0.5)
    ]
    rpe = rt.calculate_rpe(segments)
    print("Relative Pose Error (RPE)")
    for d, (o, p) in sorted(rpe.items()):
        print(
            f"  seg {d:7.2f} m: ori med {o.median:.4f} deg | pos med {p.median:.4f} m"
            f" ({len(p.values)} samples)"
        )
    try:
        no, npos = rt.calculate_nees()
        print(f"NEES: ori mean {no.mean:.3f} | pos mean {npos.mean:.3f}")
    except ValueError:
        print("NEES: estimate has no covariance columns (skipped)")


def cmd_timing_percentages(args):
    from cuahn_vio_torch.eval.traj_io import load_timing_file

    names = ["load_img", "propagation", "network", "ekf_update", "total"]
    for path in args.files:
        t, stages = load_timing_file(path)
        total = stages[:, 4]
        print(f"== {path} ({len(t)} frames)")
        for i, n in enumerate(names[:4]):
            pct = 100.0 * stages[:, i].sum() / max(total.sum(), 1e-9)
            print(
                f"  {n:12s} mean {stages[:, i].mean():8.3f} ms "
                f"median {np.median(stages[:, i]):8.3f} ms  ({pct:5.1f} %)"
            )
        print(
            f"  {'total':12s} mean {total.mean():8.3f} ms  "
            f"=> {1000.0 / max(total.mean(), 1e-9):.1f} fps"
        )


def cmd_error_simulation(args):
    """State/bias errors + NEES against simulator ground truth
    (error_simulation.cpp / ResultSimulation analog)."""
    from cuahn_vio_torch.eval.simulation import ResultSimulation, load_state_gt

    d = np.load(args.est)
    gt = load_state_gt(args.gt)
    sim = ResultSimulation(
        d["times"], d["pose"], gt,
        est_v_body=d.get("v_body"), est_ba=d.get("ba"), est_bg=d.get("bg"),
        est_cov_diag=d.get("cov_diag"), est_cov_core=d.get("cov_core"),
    )
    summary = sim.summary()
    print(f"matched {len(sim.times)} est/gt pairs")
    for k, v in summary.items():
        print(f"  {k:10s} {v:.6f}")
    if sim.cov_core is not None:
        obs = sim.calculate_nees_observable()
        print("  observable-subspace NEES (gauge directions excluded — "
              "world x/y + yaw are unobservable by construction):")
        print(f"    height 1-DoF: mean {obs['height'].mean:9.3f} "
              f"median {obs['height'].median:7.3f} (target ~1)")
        print(f"    tilt   2-DoF: mean {obs['tilt'].mean:9.3f} "
              f"median {obs['tilt'].median:7.3f} (target ~2)")
        if obs["vel"] is not None:
            print(f"    vel    3-DoF: mean {obs['vel'].mean:9.3f} "
                  f"median {obs['vel'].median:7.3f} (target ~3)")
    if sim.cov is not None:
        neo, nep = sim.calculate_nees()
        print("  full-state NEES (gauge-polluted: unobservable world-x/y "
              "and yaw drift carry no covariance and leak into every "
              "robocentric component — see calculate_nees_observable):")
        print(f"    ori  mean {neo.mean:.3f} (roll/pitch 2-DoF)")
        print(f"    pos  mean {nep.mean:.3f} median {nep.median:.3f}")
    if args.plot:
        from cuahn_vio_torch.eval.plots import render, simulation_errors
        from cuahn_vio_torch.utils.png import write_png

        write_png(args.plot, render(simulation_errors(sim)))
        print(f"wrote {args.plot}")


def cmd_plot_trajectories(args):
    """The xy of each pose file (plot_trajectories.cpp analog)."""
    from cuahn_vio_torch.eval.plots import render, trajectories
    from cuahn_vio_torch.utils.png import write_png

    write_png(args.out, render(trajectories(args.files)))
    print(f"wrote {args.out}")


def cmd_plot_trackhist(args):
    """Corner-flow track history drawn over a video frame: the offline
    analog of the reference's /cuahn/trackhist image topic
    (RosVisualizer.cpp:33-48 publish_trackhist), with the innovation chi2
    under it (``eval/plots.trackhist``)."""
    from cuahn_vio_torch.eval.plots import render, trackhist
    from cuahn_vio_torch.utils.png import write_png

    seq = np.load(args.sequence)
    log = np.load(args.state)
    if "net_mean" not in log:
        raise SystemExit("state log has no net_mean — re-run run-vio --state-out with "
                         "this version")
    write_png(args.out, render(trackhist(seq["frames"], log, args.frame, args.history)))
    print(f"wrote {args.out}")


def cmd_timing_flamegraph(args):
    """Stacked per-stage timing over the run (timing_flamegraph.cpp
    analog)."""
    from cuahn_vio_torch.eval.plots import flamegraph, render
    from cuahn_vio_torch.utils.png import write_png

    write_png(args.out, render(flamegraph(args.file)))
    print(f"wrote {args.out}")


def cmd_watch_run(args):
    """Live progress view of a running estimate file: poll the pose txt as
    run-vio writes it, align GT onto the estimate so far, and refresh an
    xy-plot PNG (live_align_trajectory.cpp:38-137 analog); exits after
    ``--stale-ticks`` polls without growth or ``--max-ticks`` polls."""
    import time

    from cuahn_vio_torch.eval.plots import render, watch
    from cuahn_vio_torch.eval.traj_io import load_pose_file
    from cuahn_vio_torch.utils.png import write_png

    gt = load_pose_file(args.gt) if args.gt else None
    last_n, stale, ticks = -1, 0, 0
    while True:
        try:
            est = load_pose_file(args.est)
            n = len(est.times)
        except (FileNotFoundError, ValueError):
            n = 0
        stale = stale + 1 if n == last_n else 0
        if n > 1 and n != last_n:
            write_png(args.out, render(watch(est, gt, args.method)))
            print(f"[watch-run] {n} poses -> {args.out}", flush=True)
        last_n = n
        ticks += 1
        if args.max_ticks and ticks >= args.max_ticks:
            return
        if stale >= args.stale_ticks:
            print("[watch-run] estimate stopped growing; exiting", flush=True)
            return
        time.sleep(args.interval)


def cmd_calibrate_covariance(args):
    """Fit the measurement-covariance temperature k_net_cov (the
    reference's hand-tuned K_net_Cov=10, UpdaterHNet.cpp:31-33) from a
    logged run so the innovation chi2 median hits the 8-DoF ideal."""
    from cuahn_vio_torch.eval.calibration import fit_from_state_npz

    res = fit_from_state_npz(args.state, target_median=args.target_median)
    print(f"frames used:        {res['n_frames']}")
    print(
        f"fitted k_net_cov:   {res['k_net_cov']:.4g} "
        f"(reference hand-tuned value: 10.0)"
    )
    print(
        f"chi2 under fit:     median {res['chi2_median']:.2f} "
        f"(target {res['target_median']:.2f}), p95 {res['chi2_p95']:.1f}, "
        f"mean {res['chi2_mean']:.2f}"
    )
    print(
        "apply: set up_linear_k_hnet_cov: "
        f"{res['k_net_cov']:.4g} in the YAML config (or --k-net-cov), "
        "re-run, and re-check the printed chi2 median"
    )


def cmd_calibrate_state_covariance(args):
    """Fit reported-covariance inflation factors from a logged run vs its
    state GT (``eval.calibration.fit_cov_inflation``). Fit on a calibration
    sequence; pass the printed flag to run-vio on evaluation sequences. A
    log whose covariance ``run-vio --cov-calib`` already inflated is
    refused: fitting on it would compound the factors."""
    from cuahn_vio_torch.eval.calibration import fit_cov_inflation, recorded_inflation

    recorded = recorded_inflation(np.load(args.state_log))
    if recorded is not None:
        raise SystemExit(
            f"{args.state_log}: its covariance was already inflated by run-vio --cov-calib "
            f"(recorded factors {recorded}); fitting on it would compound the factors. "
            "Fit on a log written without --cov-calib.")
    f = fit_cov_inflation(args.state_log, args.state_gt)
    print(f"fitted observable-NEES inflation factors: {f}")
    print(
        "run-vio flag:  --cov-calib "
        f"pos:{f['pos']:.3g},ori:{f['ori']:.3g},vel:{f['vel']:.3g}"
    )


def cmd_eval_flow(args):
    """Network measurement quality in isolation on ``--device``: the UAHN
    on every consecutive frame pair of a rendered sequence against the
    oracle flow of the simulator GT poses (``eval.flow``)."""
    from cuahn_vio_torch.eval.flow import eval_flow, flow_report
    from cuahn_vio_torch.eval.simulation import load_state_gt
    from cuahn_vio_torch.models.uahn import build_uahn
    from cuahn_vio_torch.ops.homography import f32_parity_mode
    from cuahn_vio_torch.utils.checkpoint import load_params
    from cuahn_vio_torch.utils.config import VioOptions

    device = _device(args.device)
    f32_parity_mode()
    opts = VioOptions.from_yaml(args.config) if args.config else VioOptions.uzhfpv_indoor45()
    fp = opts.filter_params(device)
    d = np.load(args.sequence)
    gt = load_state_gt(args.state_gt)
    # the JAX verb's UAHN: init_uahn's defaults (dropout 0.05, blocks 3)
    model = build_uahn(load_params(args.weights), device=device)
    ev = eval_flow(d["frames"], d["cam_t"], gt.times, gt.pose, fp.c_rot_i, fp.i_t_i2c, model,
                   prior=args.prior, batch=args.batch, limit=args.limit, seed=args.seed)
    for line in flow_report(ev, args.prior, args.flow_cap):
        print(line)
    if args.out:
        np.savez_compressed(args.out, pred=ev.pred, true=ev.true, cov=ev.cov, times=ev.times)
        print(f"wrote {args.out}")


def cmd_inspect_frame(args):
    """Run the network (blocks 1-4, no prior) on one frame pair of a
    sequence on ``--device`` and dump diagnostics: the predicted
    flow/covariance and the photometric error map |warp(img2, H) - img1|
    * 255 (the show_photometric_error display of HomographyNet.cpp:199-207),
    written with img1 and img2 as one greyscale PNG (``utils.png``)."""
    import torch

    from cuahn_vio_torch.models.uahn import build_uahn, init_uahn
    from cuahn_vio_torch.ops.homography import f32_parity_mode
    from cuahn_vio_torch.utils.checkpoint import load_params
    from cuahn_vio_torch.utils import prng
    from cuahn_vio_torch.utils.png import write_png

    device = _device(args.device)
    f32_parity_mode()
    frames = np.load(args.sequence)["frames"]
    f = args.frame
    pair = torch.as_tensor(frames[f: f + 2], device=device).to(torch.float32) / 255.0
    # without weights, the JAX verb's init_uahn(PRNGKey(0))
    model = (build_uahn(load_params(args.weights), device=device) if args.weights
             else init_uahn(prng.prng_key(0), device=device))
    # the JAX verb's rngs={"dropout": PRNGKey(seed)}
    flow, cov, err_map = model(pair[:1], pair[1:], None, use_prior=False,
                               dropout_keys=prng.prng_key(args.seed)[None],
                               return_error_map=True)
    print("4pt flow (px):", flow[0].cpu().numpy().round(3))
    print("cov diag (px^2):", torch.diagonal(cov[0]).cpu().numpy().round(3))
    # the figure: img1 x 255, img2 x 255 and the error map side by side,
    # each rounded and clipped to 0-255
    panels = torch.cat([pair[0] * 255.0, pair[1] * 255.0, err_map[0]], dim=1)
    write_png(args.out, torch.clamp(torch.round(panels), 0, 255).to(torch.uint8).cpu().numpy())
    print(f"wrote {args.out} (mean photometric err {float(err_map.mean()):.2f})")


def cmd_track_features(args):
    """Sparse KLT feature tracking over a sequence on ``--device`` (the
    reference's test_tracking demo, ov_core/src/test_tracking.cpp):
    grid-detect corners, track them frame to frame, re-detect in cells
    whose track died, and write per-frame track arrays
    (``vision.klt.track_sequence``)."""
    import torch

    from cuahn_vio_torch.ops.homography import f32_parity_mode
    from cuahn_vio_torch.vision.klt import track_sequence

    device = _device(args.device)
    f32_parity_mode()
    d = np.load(args.sequence)
    frames = d["frames"]
    n = min(len(frames), args.max_frames or len(frames))
    frames_dev = torch.as_tensor(frames[:n], device=device)  # uint8, to the device once
    pts, valid, ids, ms = track_sequence(frames_dev, n, args.grid_y, args.grid_x)
    survivors = int((ids[-1] == ids[0]).sum())
    print(f"tracked {pts.shape[1]} slots over {n} frames, {ms:.2f} ms/frame; "
          f"{survivors} survivors from frame 0")
    np.savez_compressed(args.out, pts=pts, valid=valid, ids=ids, times=d["cam_t"][:n])
    print(f"wrote tracks -> {args.out}")


def cmd_error_dataset(args):
    """ATE of every run in a directory against one GT (numpy only)."""
    import glob
    import os

    from cuahn_vio_torch.eval.metrics import ResultTrajectory

    runs = sorted(glob.glob(os.path.join(args.runs, "*.txt")))
    print(f"{'run':40s} {'ATE pos (m)':>12s} {'ATE ori (deg)':>14s}")
    rmses = []
    for run in runs:
        try:
            rt = ResultTrajectory.from_files(run, args.gt, args.align)
            ori, pos = rt.calculate_ate()
            rmses.append(pos.rmse)
            print(f"{os.path.basename(run):40s} {pos.rmse:12.4f} {ori.rmse:14.4f}")
        except Exception as e:  # noqa: BLE001
            print(f"{os.path.basename(run):40s} FAILED: {e}")
    if rmses:
        print(f"{'mean':40s} {np.mean(rmses):12.4f}")


def cmd_error_comparison(args):
    """algorithms x datasets matrix: args.root/<algo>/<dataset>.txt vs
    args.gt_dir/<dataset>.txt (error_comparison.cpp layout; numpy only)."""
    import glob
    import os

    from cuahn_vio_torch.eval.metrics import ResultTrajectory

    algos = sorted(
        d for d in os.listdir(args.root) if os.path.isdir(os.path.join(args.root, d))
    )
    gts = sorted(glob.glob(os.path.join(args.gt_dir, "*.txt")))
    names = [os.path.splitext(os.path.basename(g))[0] for g in gts]
    print("ATE pos rmse (m)")
    print(f"{'algorithm':24s} " + " ".join(f"{n[:14]:>15s}" for n in names))
    for algo in algos:
        row = []
        for gt, name in zip(gts, names):
            est = os.path.join(args.root, algo, name + ".txt")
            if not os.path.exists(est):
                row.append("    -")
                continue
            try:
                rt = ResultTrajectory.from_files(est, gt, args.align)
                _, pos = rt.calculate_ate()
                row.append(f"{pos.rmse:15.4f}")
            except Exception:  # noqa: BLE001
                row.append(f"{'err':>15s}")
        print(f"{algo:24s} " + " ".join(row))


def cmd_timing_comparison(args):
    """Side-by-side stage statistics for several runs
    (timing_comparison.cpp analog; numpy only)."""
    import os

    from cuahn_vio_torch.eval.traj_io import load_timing_file

    names = ["load_img", "propagation", "network", "ekf_update", "total"]
    print(f"{'run':30s} " + " ".join(f"{n:>12s}" for n in names))
    for path in args.files:
        _, stages = load_timing_file(path)
        means = stages.mean(axis=0)
        print(f"{os.path.basename(path)[:30]:30s} " + " ".join(f"{m:9.3f} ms" for m in means))
        p95 = np.percentile(stages, 95, axis=0)
        print(f"{'  (p95)':30s} " + " ".join(f"{m:9.3f} ms" for m in p95))


def cmd_align_trajectory(args):
    """Associate and align GT onto the estimate's frame and write the
    aligned GT file (live_align_trajectory.cpp:38-137 analog, offline;
    numpy only)."""
    from cuahn_vio_torch.eval.align import (
        align_trajectory,
        associate_indices,
        jpl_quat_to_rot,
        jpl_rot_to_quat,
    )
    from cuahn_vio_torch.eval.traj_io import load_pose_file, save_pose_file

    est = load_pose_file(args.est)
    gt = load_pose_file(args.gt)
    ie, ig = associate_indices(est.times, gt.times)
    if len(ie) == 0:
        raise SystemExit("no overlapping timestamps")
    # rotate/translate GT into the estimate frame: est ~ R @ gt + t
    r, t, s = align_trajectory(gt.poses[ig], est.poses[ie], method=args.method)
    poses = gt.poses.copy()
    poses[:, :3] = s * (r @ gt.poses[:, :3].T).T + t
    for i in range(len(poses)):
        rot = jpl_quat_to_rot(gt.poses[i, 3:7]).T  # body->world
        poses[i, 3:7] = jpl_rot_to_quat((r @ rot).T)
    save_pose_file(args.out, gt.times, poses)
    print(f"aligned {len(ie)} matched poses ({args.method}) -> {args.out}")


def cmd_pid_monitor(args):
    """Sample CPU%/RSS of a process (ov_eval/python/pid_sys.py analog,
    read from /proc; numpy only)."""
    import json
    import time

    from cuahn_vio_torch.eval.recorder import ResourceMonitor

    mon = ResourceMonitor(pid=args.pid, interval=args.interval).start()
    try:
        time.sleep(args.duration)
    finally:
        print(json.dumps(mon.stop()))


# VERDICT.md:163-170: the replay is open loop, so at v10's quality it
# diverges (best grid point 1.18 m against 0.353 m for a real run)
TUNE_WARNING = (
    "tune-filter: warning: the sweep replays logged measurements open loop; with "
    "v10-class weights the closed loop is tight enough that the replayed measurements "
    "are inconsistent and the sweep diverges (best grid point 1.18 m against 0.353 m "
    "for a real run): confirm any winner with a real run-vio"
)


def cmd_tune_filter(args):
    """Filter-parameter grid sweep over a logged measurement stream
    (``eval/tuning.py``): the whole grid replayed at once on ``--device``.
    First-order (the prior feeds back into the network): confirm winners
    with a real run-vio. Prints the divergence warning once on stderr."""
    import itertools
    import json

    from cuahn_vio_torch.eval.simulation import load_state_gt
    from cuahn_vio_torch.eval.traj_io import load_pose_file
    from cuahn_vio_torch.eval.tuning import SweepConfig, replay_measurements, score_sweep
    from cuahn_vio_torch.ops.homography import f32_parity_mode
    from cuahn_vio_torch.utils.config import VioOptions

    device = _device(args.device)
    f32_parity_mode()
    opts = (
        VioOptions.from_yaml(args.config) if args.config
        else VioOptions.uzhfpv_indoor45().apply_profile("calibrated")
    )
    d = np.load(args.sequence)
    log = np.load(args.state_log)

    def axis(spec, default):
        return [float(x) for x in spec.split(",")] if spec else [default]

    grid = [
        SweepConfig(
            k_net_cov=k, chi2_gate=g, q_scale=q, q_pos_extra=qp,
            bias_sigma_px=bs, bias_tau=bt,
            chi2_soft=(cs if cs > 0 else float("inf")), echo_beta=eb,
        )
        for k, g, q, qp, bs, bt, cs, eb in itertools.product(
            axis(args.k_net_cov, opts.up_linear_k_hnet_cov),
            axis(args.chi2_gate, opts.chi2_gate),
            axis(args.q_scale, opts.process_noise_scale),
            axis(args.q_pos_extra, opts.extra_position_noise),
            axis(args.bias_sigma_px, opts.meas_bias_sigma_px),
            axis(args.bias_tau, opts.meas_bias_tau),
            axis(args.chi2_soft, opts.chi2_soft),
            axis(args.echo_beta, opts.echo_beta),
        )
    ]
    print(TUNE_WARNING, file=sys.stderr, flush=True)
    print(f"sweeping {len(grid)} grid points...")
    net_mean, net_cov88 = log["net_mean"], log["net_cov88"]
    # the JAX verb's trim: drop leading measurement-free rows while the
    # log has more rows than the sequence has frame pairs from the log's
    # first (IMU-clock) time on; run-vio logs one row per frame pair, so
    # for its logs this drops nothing
    t_cam0 = log["times"][0] - opts.calib_camimu_dt
    n_pairs = len(d["cam_t"]) - int(np.searchsorted(d["cam_t"], t_cam0 - 1e-4))
    while len(net_mean) > n_pairs and np.trace(net_cov88[0]) == 0:
        net_mean, net_cov88 = net_mean[1:], net_cov88[1:]
    outs, times = replay_measurements(
        d["imu_t"], d["imu_w"], d["imu_a"], d["cam_t"], net_mean, net_cov88,
        opts.filter_params(device), grid, opts.runner_options(), opts.vio_config(),
    )
    gt = load_pose_file(args.gt)
    state_gt = load_state_gt(args.state_gt) if args.state_gt else None
    rows = score_sweep(outs, times, gt.times, gt.poses, state_gt, grid)
    rows.sort(key=lambda r: r.get("ate_pos", float("inf")))
    for r in rows[: args.top]:
        print(json.dumps(r))
    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
        print(f"wrote {len(rows)} rows -> {args.out}")


def cmd_distributed_selftest(args):
    """Join a multi-process job (``--coordinator``; none: one process) and
    run the deterministic sharded workload (``parallel/selftest.py``) on
    ``--device``; prints one JSON line. The checksums must match a
    single-process run to float32 tolerance."""
    import json

    from cuahn_vio_torch.parallel.mesh import init_distributed
    from cuahn_vio_torch.parallel.selftest import run_selftest, run_selftest_bench

    device = _device(args.device)
    if args.coordinator:
        init_distributed(args.coordinator, args.num_processes, args.process_id, device=device)
    try:
        if args.bench:
            res = run_selftest_bench(args.mesh_devices, device=device)
        else:
            res = run_selftest(args.mesh_devices, device=device)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cuahn_vio_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("error-singlerun", help="ATE/RPE/NEES of one run")
    s.add_argument("align", choices=["posyaw", "posyawsingle", "se3", "se3single", "sim3",
                                     "none"])
    s.add_argument("gt")
    s.add_argument("est")
    s.add_argument("--segments", default=None, help="comma list of RPE segment lengths (m)")
    s.set_defaults(fn=cmd_error_singlerun)

    s = sub.add_parser("timing-percentages", help="stage timing breakdown")
    s.add_argument("files", nargs="+")
    s.set_defaults(fn=cmd_timing_percentages)

    s = sub.add_parser("error-simulation", help="state/bias errors + NEES vs sim GT")
    s.add_argument("est", help="state .npz from run-vio --state-out")
    s.add_argument("gt", help="17-column sim state GT txt")
    s.add_argument("--plot", default=None, help="write error/3-sigma plot PNG")
    s.set_defaults(fn=cmd_error_simulation)

    s = sub.add_parser("plot-trajectories", help="xy plot of trajectories")
    s.add_argument("files", nargs="+")
    s.add_argument("--out", default="trajectories.png")
    s.set_defaults(fn=cmd_plot_trajectories)

    s = sub.add_parser("plot-trackhist", help="corner-flow track history over a frame")
    s.add_argument("sequence", help=".npz sequence (frames)")
    s.add_argument("state", help=".npz from run-vio --state-out")
    s.add_argument("--frame", type=int, default=None,
                   help="state-log row to highlight (default: last)")
    s.add_argument("--history", type=int, default=45,
                   help="how many past frames of flow to draw")
    s.add_argument("--out", default="trackhist.png")
    s.set_defaults(fn=cmd_plot_trackhist)

    s = sub.add_parser("timing-flamegraph", help="stacked stage-time plot")
    s.add_argument("file")
    s.add_argument("--out", default="timing_flamegraph.png")
    s.set_defaults(fn=cmd_timing_flamegraph)

    s = sub.add_parser("watch-run", help="live xy plot of a growing estimate")
    s.add_argument("est", help="pose txt being written by run-vio")
    s.add_argument("--gt", default=None, help="GT pose txt to align+overlay")
    s.add_argument("--out", default="watch.png")
    s.add_argument("--method", default="posyaw", choices=["posyaw", "se3", "sim3", "none"])
    s.add_argument("--interval", type=float, default=1.0, help="poll seconds")
    s.add_argument("--stale-ticks", type=int, default=10,
                   help="exit after this many polls without growth")
    s.add_argument("--max-ticks", type=int, default=0, help="hard tick limit (0 = none)")
    s.set_defaults(fn=cmd_watch_run)

    s = sub.add_parser("run-vio", help="run the VIO on a sequence")
    s.add_argument("sequence", help=".npz with imu_t/imu_w/imu_a/cam_t/frames")
    s.add_argument("--config", default=None)
    s.add_argument("--profile", choices=["launch", "calibrated"], default=None,
                   help="named filter-tuning profile; default: calibrated "
                        "when no --config is given")
    s.add_argument("--weights", default=None)
    s.add_argument("--out", default="stamped_traj_estimate.txt")
    s.add_argument("--state-out", default=None,
                   help=".npz with v/biases/cov diag for error-simulation")
    s.add_argument("--no-network", action="store_true", help="dead reckoning")
    s.add_argument("--init-height", type=float, default=None)
    s.add_argument("--init-imu-thresh", type=float, default=None)
    s.add_argument("--calib-dt", type=float, default=None)
    s.add_argument("--k-net-cov", type=float, default=None)
    s.add_argument("--chi2-gate", type=float, default=None)
    s.add_argument("--iekf", type=int, default=None)
    s.add_argument("--no-prior", action="store_true",
                   help="run all 4 network blocks instead of the prior cascade")
    s.add_argument("--q-scale", type=float, default=None)
    s.add_argument("--q-pos-extra", type=float, default=None)
    s.add_argument("--bias-sigma-px", type=float, default=None)
    s.add_argument("--bias-tau", type=float, default=None)
    s.add_argument("--chi2-soft", type=float, default=None)
    s.add_argument("--echo-beta", type=float, default=None)
    s.add_argument("--seed", type=int, default=0,
                   help="MC-dropout seed (the JAX verb's PRNGKey(seed))")
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    s.add_argument("--timing-out", default=None,
                   help="per-frame stage timing csv; runs the stepwise runner "
                        "(with the divergence guard)")
    s.add_argument("--odom-out", default=None,
                   help="FRD odometry txt (visualize_odometry analog)")
    s.add_argument("--bf16", action="store_true", help="bfloat16 conv towers")
    s.add_argument("--cov-calib", default=None,
                   help="reported-covariance calibration factors, e.g. "
                        "'pos:5.1,ori:3.4,vel:8.7' (output covariance only, gains "
                        "untouched; the npz of --state-out records them)")
    s.set_defaults(fn=cmd_run_vio)

    s = sub.add_parser("run-vio-batch", help="many sequences in lockstep on one card")
    s.add_argument("sequences", nargs="+", help=".npz sequence files")
    s.add_argument("--out-dir", default="batch_out")
    s.add_argument("--config", default=None)
    s.add_argument("--profile", choices=["launch", "calibrated"], default=None)
    s.add_argument("--weights", default=None,
                   help="UAHN weights; default: the config's network_weights_path, as "
                        "run-vio (the JAX verb reads only --weights and otherwise runs "
                        "a randomly initialized UAHN)")
    s.add_argument("--no-network", action="store_true")
    s.add_argument("--init-height", type=float, default=None)
    s.add_argument("--seed", type=int, default=0,
                   help="MC-dropout seed (the JAX verb's PRNGKey(seed))")
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    s.add_argument("--mesh", action="store_true",
                   help="shard the batch over the job's devices (one process: one)")
    s.set_defaults(fn=cmd_run_vio_batch)

    s = sub.add_parser("make-synthetic", help="generate a synthetic sequence")
    s.add_argument("--out", default="synthetic_seq.npz")
    s.add_argument("--duration", type=float, default=20.0)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--sigma-w", type=float, default=0.0)
    s.add_argument("--sigma-a", type=float, default=0.0)
    s.add_argument("--bias-g", type=float, default=0.0)
    s.add_argument("--bias-a", type=float, default=0.0)
    s.add_argument("--config", default=None)
    s.add_argument("--texture", choices=["none", "train", "heldout"], default="none",
                   help="ground imagery: procedural sinusoids (none), or a photo "
                        "from the texture bank's train/held-out split")
    s.add_argument("--texture-pick", type=int, default=None,
                   help="index into the chosen split (default: seed)")
    s.add_argument("--tex-scale", type=float, default=4.0,
                   help="metres per texture period")
    s.add_argument("--exposure-ms", type=float, default=0.0,
                   help="camera exposure time; > 0 renders each frame as the mean "
                        "of 3 poses across the exposure window (physical motion blur)")
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # shape a --traj-file trajectory only; without one they change nothing,
    # as in the JAX verb
    s.add_argument("--spline-dt", type=float, default=0.5,
                   help="B-spline knot spacing of --traj-file (s; unused without it)")
    s.add_argument("--traj-z-offset", type=float, default=0.0,
                   help="height offset of --traj-file (unused without it)")
    s.add_argument("--effects", action="store_true",
                   help="sensor-effect augmentation (vignette, exposure, noise, "
                        "defocus), one draw per sequence from --seed")
    s.add_argument("--traj-file", default=None,
                   help="'# t x y z qx qy qz qw' pose txt to fly (a B-spline "
                        "through it) instead of the analytic trajectory")
    s.set_defaults(fn=cmd_make_synthetic)

    s = sub.add_parser("format-converter", help="EuRoC csv <-> pose txt")
    s.add_argument("input")
    s.add_argument("output")
    s.set_defaults(fn=cmd_format_converter)

    s = sub.add_parser("convert-euroc", help="EuRoC-ASL dir -> sequence .npz")
    s.add_argument("root", help="dataset root containing mav0/")
    s.add_argument("--out", default="sequence.npz")
    s.add_argument("--config", default=None)
    s.add_argument("--max-frames", type=int, default=None)
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    s.set_defaults(fn=cmd_convert_euroc)

    s = sub.add_parser(
        "distort-to-euroc",
        help="rendered .npz -> RAW distorted EuRoC dir (full-chain tests)",
    )
    s.add_argument("sequence", help=".npz from make-synthetic")
    s.add_argument("--out", required=True, help="EuRoC root dir to create")
    s.add_argument("--config", default=None)
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    s.set_defaults(fn=cmd_distort_to_euroc)

    s = sub.add_parser("train-uahn", help="train network weights from scratch")
    s.add_argument("--out", default="uahn_weights.msgpack")
    s.add_argument("--steps", type=int, default=2000)
    s.add_argument("--batch-size", type=int, default=16)
    s.add_argument("--lr", type=float, default=2e-4)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--save-every", type=int, default=250)
    s.add_argument("--config", default=None)
    s.add_argument("--resume", default=None,
                   help="continue from an existing weights checkpoint (Flax msgpack)")
    s.add_argument("--trans-sigma", type=float, default=0.06,
                   help="inter-frame translation sigma (m)")
    s.add_argument("--rot-sigma", type=float, default=0.025)
    s.add_argument("--prior-noise-px", type=float, default=3.0)
    s.add_argument("--height-min", type=float, default=0.8,
                   help="camera height range sampled during training (m); "
                        "flow magnitude scales as translation/height, so the "
                        "low end controls the hardest samples")
    s.add_argument("--height-max", type=float, default=3.0)
    s.add_argument("--tilt-sigma", type=float, default=0.12,
                   help="absolute roll/pitch sigma (rad); large values "
                        "include near-horizon views with little ground texture")
    s.add_argument("--no-textures", action="store_true",
                   help="disable the photo texture bank (procedural sinusoid ground)")
    s.add_argument("--no-effects", action="store_true",
                   help="disable sensor-effect augmentation (vignette, "
                        "exposure, noise, defocus; the motion blur stays)")
    s.add_argument("--exposure-frac-max", type=float, default=0.5,
                   help="max motion-blur exposure, fraction of frame dt")
    s.add_argument("--max-flow-px", type=float, default=80.0,
                   help="samples with corner flow beyond this are masked")
    s.add_argument("--prior-noise-lo", type=float, default=1.0,
                   help="low end of the log-uniform simulated-prior noise "
                        "sigma range (px)")
    s.add_argument("--echo-weight", type=float, default=0.0,
                   help="prior-echo decorrelation penalty weight "
                        "(TrainConfig.echo_weight)")
    s.add_argument("--big-baseline-prob", type=float, default=0.0,
                   help="fraction of samples with stretched translation "
                        "(loop-closure 100-250 px flow curriculum)")
    s.add_argument("--traj-pair-prob", type=float, default=0.7,
                   help="fraction of samples drawn from the real-flight "
                        "pose-pair bank (data/trajpairs.py; random poses while "
                        "its GT files are absent)")
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    s.set_defaults(fn=cmd_train_uahn)

    s = sub.add_parser("close-loops", help="UAHN loop factors for a run")
    s.add_argument("sequence", help=".npz sequence (frames)")
    s.add_argument("state", help="state .npz from run-vio --state-out")
    s.add_argument("--weights", required=True)
    s.add_argument("--config", default=None)
    s.add_argument("--out", default="loops.txt")
    s.add_argument("--min-dt", type=float, default=3.0)
    s.add_argument("--max-dist", type=float, default=1.0)
    s.add_argument("--stride", type=int, default=5)
    s.add_argument("--max-pairs", type=int, default=32)
    s.add_argument("--max-sigma-px", type=float, default=4.0,
                   help="confidence gate: drop factors whose mean network "
                        "corner sigma exceeds this (survivors carry their "
                        "own per-factor sigma, so a looser gate only adds "
                        "weakly-weighted factors)")
    s.add_argument("--max-prior-px", type=float, default=50.0,
                   help="geometric gate: skip pairs whose predicted corner "
                        "flow exceeds the network's training regime")
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    s.set_defaults(fn=cmd_close_loops)

    s = sub.add_parser("smooth-trajectory", help="pose-graph smoothing of a run")
    s.add_argument("est", help="pose txt to smooth")
    s.add_argument("--out", default="smoothed.txt")
    s.add_argument("--loops", default=None, help="loop pairs 'a:b,c:d'")
    s.add_argument("--loops-file", default=None,
                   help="factor file from close-loops")
    s.add_argument("--iters", type=int, default=10)
    s.add_argument("--sigma-dp", type=float, default=0.02)
    s.add_argument("--sigma-dth", type=float, default=0.01)
    s.add_argument("--loop-sigma-dp", type=float, default=None)
    s.add_argument("--loop-sigma-dth", type=float, default=None)
    s.add_argument("--huber", type=float, default=0.0,
                   help="IRLS robust threshold (redescending Cauchy kernel) "
                        "on the whitened per-factor residual norm, in sigmas "
                        "(0 = plain least squares); drives confident-outlier "
                        "loop factors to ~zero weight")
    s.add_argument("--loop-sigma-scale", type=float, default=1.0,
                   help="multiply per-factor loop sigmas (col 10) by this "
                        "calibration factor")
    s.add_argument("--mesh", action="store_true",
                   help="block-partitioned Schur solve over the job's devices "
                        "(refused with --huber > 0)")
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    s.set_defaults(fn=cmd_smooth_trajectory)

    s = sub.add_parser(
        "train-fil",
        help="filter-in-the-loop fine-tune: optimize weights through the "
             "deployed EKF recurrence on real-trajectory windows (train/fil.py)",
    )
    s.add_argument("--resume", required=True,
                   help="weights checkpoint to fine-tune")
    s.add_argument("--out", default="uahn_fil.msgpack")
    s.add_argument("--steps", type=int, default=2000)
    s.add_argument("--window", type=int, default=6)
    s.add_argument("--batch-size", type=int, default=4)
    s.add_argument("--lr", type=float, default=2e-5)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--save-every", type=int, default=200)
    s.add_argument("--pair-step-every", type=int, default=2,
                   help="interleave a standard single-pair training step "
                        "every N steps (NLL anchor for the cov head); "
                        "0 disables")
    s.add_argument("--w-cons", type=float, default=0.0,
                   help="filter-consistency (NEES) penalty weight "
                        "(FilConfig.w_cons)")
    s.add_argument("--config", default=None)
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    s.set_defaults(fn=cmd_train_fil)

    s = sub.add_parser(
        "calibrate-covariance",
        help="fit k_net_cov from a run-vio --state-out log",
    )
    s.add_argument("state", help=".npz from run-vio --state-out")
    s.add_argument("--target-median", type=float, default=7.3441,
                   help="target innovation chi2 median (8-DoF ideal)")
    s.set_defaults(fn=cmd_calibrate_covariance)

    s = sub.add_parser(
        "calibrate-state-covariance",
        help="fit reported-covariance NEES calibration factors from a "
             "logged run (apply via run-vio --cov-calib)",
    )
    s.add_argument("state_log", help="run-vio --state-out npz (without --cov-calib)")
    s.add_argument("state_gt", help="17-col sim state GT txt")
    s.set_defaults(fn=cmd_calibrate_state_covariance)

    s = sub.add_parser(
        "eval-flow", help="network flow error vs oracle (filter-independent)"
    )
    s.add_argument("sequence", help=".npz sequence (frames + cam_t)")
    s.add_argument("state_gt", help="simulator state GT txt (17-col)")
    s.add_argument("--weights", required=True)
    s.add_argument("--config", default=None)
    s.add_argument("--prior", choices=["none", "gt", "noisy"], default="gt",
                   help="prior fed to the cascade: none = all 4 blocks, "
                        "gt = oracle flow, noisy = oracle + 2 px noise")
    s.add_argument("--batch", type=int, default=16)
    s.add_argument("--limit", type=int, default=0)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--flow-cap", type=float, default=80.0,
                   help="px bound of the non-degenerate measurement regime")
    s.add_argument("--out", default=None, help="optional .npz dump")
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    s.set_defaults(fn=cmd_eval_flow)

    s = sub.add_parser("inspect-frame", help="network diagnostics on one frame pair")
    s.add_argument("sequence", help=".npz sequence")
    s.add_argument("--frame", type=int, default=0)
    s.add_argument("--weights", default=None)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--out", default="inspect_frame.png",
                   help="greyscale PNG: img1, img2 and the error map side by side")
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    s.set_defaults(fn=cmd_inspect_frame)

    s = sub.add_parser(
        "track-features", help="sparse KLT tracking demo (test_tracking parity)"
    )
    s.add_argument("sequence", help=".npz sequence")
    s.add_argument("--out", default="tracks.npz")
    s.add_argument("--grid-y", type=int, default=8)
    s.add_argument("--grid-x", type=int, default=10)
    s.add_argument("--max-frames", type=int, default=None)
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    s.set_defaults(fn=cmd_track_features)

    s = sub.add_parser("error-dataset", help="ATE of all runs in a dir vs one GT")
    s.add_argument("align")
    s.add_argument("gt")
    s.add_argument("runs")
    s.set_defaults(fn=cmd_error_dataset)

    s = sub.add_parser("error-comparison", help="algos x datasets ATE matrix")
    s.add_argument("align")
    s.add_argument("gt_dir")
    s.add_argument("root")
    s.set_defaults(fn=cmd_error_comparison)

    s = sub.add_parser("timing-comparison", help="stage stats across runs")
    s.add_argument("files", nargs="+")
    s.set_defaults(fn=cmd_timing_comparison)

    s = sub.add_parser("align-trajectory", help="write GT aligned to an estimate")
    s.add_argument("gt")
    s.add_argument("est")
    s.add_argument("--method", default="posyaw", choices=["posyaw", "se3", "sim3", "none"])
    s.add_argument("--out", default="aligned_gt.txt")
    s.set_defaults(fn=cmd_align_trajectory)

    s = sub.add_parser("pid-monitor", help="CPU/RSS monitor for a process")
    s.add_argument("pid", type=int)
    s.add_argument("--duration", type=float, default=10.0)
    s.add_argument("--interval", type=float, default=0.25)
    s.set_defaults(fn=cmd_pid_monitor)

    s = sub.add_parser(
        "distributed-selftest",
        help="multi-process sharded-workload checksums (torch.distributed)",
    )
    s.add_argument("--coordinator", default=None,
                   help="coordinator address host:port (omit: single process)")
    s.add_argument("--num-processes", type=int, default=None)
    s.add_argument("--process-id", type=int, default=None)
    s.add_argument("--mesh-devices", type=int, default=None,
                   help="the workload of a JAX mesh of N devices (N sequences, "
                        "N blocks); default 8, the JAX tests' mesh")
    s.add_argument("--bench", action="store_true",
                   help="timed throughput workload (scaling-efficiency "
                        "recipe) instead of the checksum workload")
    s.add_argument("--out", default=None, help="write the JSON line here")
    s.add_argument("--device", default="cuda",
                   help="cuda (default; NCCL, one process per GPU) or cpu (gloo)")
    s.set_defaults(fn=cmd_distributed_selftest)

    s = sub.add_parser(
        "tune-filter",
        help="filter-parameter grid sweep over a logged measurement stream, "
             "the whole grid at once (eval/tuning.py)",
    )
    s.add_argument("sequence", help=".npz sequence the log came from")
    s.add_argument("state_log", help="run-vio --state-out npz")
    s.add_argument("gt", help="ground-truth pose txt")
    s.add_argument("--state-gt", default=None, help="17-col sim state GT")
    s.add_argument("--config", default=None)
    s.add_argument("--k-net-cov", default=None, help="comma list, e.g. 4,7.9,12")
    s.add_argument("--chi2-gate", default=None)
    s.add_argument("--q-scale", default=None)
    s.add_argument("--q-pos-extra", default=None)
    s.add_argument("--bias-sigma-px", default=None)
    s.add_argument("--bias-tau", default=None)
    s.add_argument("--chi2-soft", default=None)
    s.add_argument("--echo-beta", default=None)
    s.add_argument("--top", type=int, default=10)
    s.add_argument("--out", default=None, help="write all rows (jsonl)")
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    s.set_defaults(fn=cmd_tune_filter)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
