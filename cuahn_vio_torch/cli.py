"""Command line of the port: ``python -m cuahn_vio_torch.cli VERB ...``.

Each verb takes the same files, flags and outputs as the JAX CLI's verb
(``python -m cuahn_vio.cli``) and runs on the card (``--device cuda``, the
default; it fails when no GPU is found):

- ``run-vio``: one sequence through ``run_offline``;
- ``run-vio-batch``: many sequences in lockstep on one card
  (``run_offline_batch``), one pose file per input;
- ``make-synthetic``: a synthetic sequence (procedural or photo-texture
  ground, sharp or motion-blurred), written as ``.npz``, ``_gt.txt``,
  ``_state_gt.txt`` and ``_config.yaml`` (the last needs PyYAML).

Flags of the JAX CLI that the port does not implement yet are refused,
never ignored.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

# run-vio flags of the JAX CLI that the port does not implement yet
NOT_YET = {
    "timing_out": "--timing-out (the per-stage timed runner)",
    "cov_calib": "--cov-calib (reported-covariance calibration)",
    "bf16": "--bf16 (bfloat16 conv towers)",
    "odom_out": "--odom-out (FRD odometry file)",
}
NOT_YET_BATCH = {
    "mesh": "--mesh (sharding the batch over a device mesh)",
}
NOT_YET_SYNTHETIC = {
    "traj_file": "--traj-file (B-spline trajectories)",
    "effects": "--effects (the sensor-effect chain)",
}


def _refuse(args, not_yet: dict, verb: str) -> None:
    refused = [flag for name, flag in not_yet.items() if getattr(args, name)]
    if refused:
        raise SystemExit(
            "not implemented in cuahn_vio_torch yet: " + ", ".join(refused)
            + f" (use python -m cuahn_vio.cli {verb})"
        )


def _device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device found; pass --device cpu to run on the CPU")
    return device


def _model(opts, weights, device):
    """The UAHN with ``weights`` (random init when None), built with
    ``opts.mc_dropout`` (the JAX CLI always uses the UAHN default, 0.05)."""
    import torch

    from cuahn_vio_torch.models.uahn import build_uahn
    from cuahn_vio_torch.utils.checkpoint import load_params

    torch.manual_seed(0)  # random init only matters without weights
    return build_uahn(
        load_params(weights) if weights else None, device=device,
        dropout_rate=opts.mc_dropout, blocks_to_run=opts.blocks_to_run,
    )


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
    from cuahn_vio_torch.eval.traj_io import save_pose_file
    from cuahn_vio_torch.pipeline.runner import run_offline

    _refuse(args, NOT_YET, "run-vio")
    device = _device(args.device)
    opts = _options(args)
    seq = _load_sequence(args.sequence)
    model = None
    if not args.no_network:
        model = _model(opts, args.weights or opts.network_weights_path, device)
    res = run_offline(
        *seq, model, opts.filter_params(device), opts.vio_config(),
        opts.runner_options(), seed=args.seed, device=device,
    )
    save_pose_file(args.out, res.times, res.pose_w, res.cov_ori, res.cov_pos)
    print(f"wrote {len(res.times)} poses -> {args.out}")
    if args.state_out:
        np.savez_compressed(
            args.state_out,
            times=res.times, pose=res.pose_w, v_body=res.v_body,
            ba=res.ba, bg=res.bg, cov_diag=res.cov_diag,
            cov_core=res.cov_core,
            net_chi2=res.net_chi2, net_inno=res.net_inno,
            cov_meas=res.cov_meas, net_cov88=res.net_cov88,
            net_mean=res.net_mean,
        )
        print(f"wrote full state -> {args.state_out}")
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

    _refuse(args, NOT_YET_BATCH, "run-vio-batch")
    device = _device(args.device)
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
    results = run_offline_batch(
        [_load_sequence(path) for path in args.sequences], model,
        opts.filter_params(device), opts.vio_config(), opts.runner_options(),
        seed=args.seed, device=device,
    )
    os.makedirs(args.out_dir, exist_ok=True)
    for path, res in zip(args.sequences, results):
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

    _refuse(args, NOT_YET_SYNTHETIC, "make-synthetic")
    device = _device(args.device)
    # the written _config.yaml records the operating point: a bare
    # invocation bakes the calibrated profile in, a user --config passes
    # through untouched
    opts = (
        VioOptions.from_yaml(args.config) if args.config
        else VioOptions.uzhfpv_indoor45().apply_profile("calibrated")
    )
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
    seq = make_sequence(
        AnalyticTrajectory(), np.asarray(opts.t_imu_to_cam),
        duration=args.duration, seed=args.seed,
        sigma_w=args.sigma_w, sigma_a=args.sigma_a,
        bias_g=args.bias_g, bias_a=args.bias_a, texture_seed=args.seed,
        texture=texture, tex_params=tex_params, exposure_s=args.exposure_ms * 1e-3,
        device=device,
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cuahn_vio_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
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
    s.add_argument("--seed", type=int, default=0, help="MC-dropout generator seed")
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # accepted only to be refused with a clear message (see NOT_YET)
    s.add_argument("--timing-out", default=None, help="not implemented yet")
    s.add_argument("--cov-calib", default=None, help="not implemented yet")
    s.add_argument("--bf16", action="store_true", help="not implemented yet")
    s.add_argument("--odom-out", default=None, help="not implemented yet")
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
    s.add_argument("--seed", type=int, default=0, help="MC-dropout generator seed")
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # accepted only to be refused with a clear message (see NOT_YET_BATCH)
    s.add_argument("--mesh", action="store_true", help="not implemented yet")
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
                   help="B-spline knot spacing of --traj-file (unused without it)")
    s.add_argument("--traj-z-offset", type=float, default=0.0,
                   help="height offset of --traj-file (unused without it)")
    # accepted only to be refused with a clear message (see NOT_YET_SYNTHETIC)
    s.add_argument("--traj-file", default=None, help="not implemented yet")
    s.add_argument("--effects", action="store_true", help="not implemented yet")
    s.set_defaults(fn=cmd_make_synthetic)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
