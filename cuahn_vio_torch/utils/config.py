"""Single config dataclass mirroring the reference's VioManagerOptions.

A copy of ``cuahn_vio.utils.config`` for the port. YAML is read and
written by the port's own ``utils.yaml_io`` (the subset these configs
use), so no config path needs PyYAML.

One structure replaces the reference's three config sources (ROS params
via parse_ros.h, CLI11 via parse_cmd.h, struct defaults in
VioManagerOptions.h / StateOptions.h / UpdaterOptions.h / NoiseManager) —
SURVEY.md §5.6. Every default below is bit-identical to the shipped UZH-FPV
launch configuration (cuahn/launch/uzhfpv.launch) where one exists.

Load/save YAML with ``VioOptions.from_yaml`` / ``to_yaml``; the
``uzhfpv_indoor45`` / ``uzhfpv_outdoor45`` constructors bake the two
sensor_config blocks of the launch file (uzhfpv.launch:80-102).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from cuahn_vio_torch.filter.state import FilterParams, make_params
from cuahn_vio_torch.pipeline.runner import RunnerOptions
from cuahn_vio_torch.pipeline.vio import VioConfig
from cuahn_vio_torch.utils import yaml_io

# T_ItoCmono, sensor_config 1: indoor 45° down-facing (uzhfpv.launch:86-92)
T_ITOC_INDOOR45 = [
    [-0.027256691772188965, -0.9996260641688061, 0.0021919370477445077, 0.02422852666805565],
    [-0.7139206120417471, 0.017931469899155242, -0.6999970157716363, 0.008974432843748055],
    [0.6996959571525168, -0.020644471939022302, -0.714142404092339, -0.000638971731537894],
    [0.0, 0.0, 0.0, 1.0],
]

# The replay-calibrated filter operating point (see VioOptions.apply_profile).
# Derivation: eval/tuning.py vmapped grid sweep over (k_net_cov, chi2_gate,
# q_scale, q_pos_extra) on run-vio --state-out measurement logs of the
# held-out textured replay, confirmed by real re-runs (the prior feeds back
# into the network, so the sweep is first-order only). k_net_cov is the
# innovation-chi2 fit of calibrate-covariance (8-DoF ideal median 7.34).
CALIBRATED_PROFILE = dict(
    up_linear_k_hnet_cov=7.9,
    chi2_gate=100.0,
    process_noise_scale=30.0,
    extra_position_noise=1.0e-2,
)

# The launch-parity values of every field any profile touches (the
# dataclass defaults restated), so --profile launch is a real reset even
# when the loaded YAML carries another operating point.
LAUNCH_PROFILE = dict(
    up_linear_k_hnet_cov=10.0,
    chi2_gate=1000.0,
    process_noise_scale=1.0,
    extra_position_noise=1.0e-4,
    meas_bias_sigma_px=0.0,
    meas_bias_tau=2.0,
    chi2_soft=0.0,
    echo_beta=0.0,
)

# T_C0toI, sensor_config 3: outdoor 45° (uzhfpv.launch:97-102); invert to ItoC
T_C0TOI_OUTDOOR45 = [
    [-0.02404152, -0.71845273, 0.69516018, 0.02496917],
    [-0.99966408, 0.0105427, -0.02367658, 0.01950941],
    [0.00968164, -0.69549588, -0.71846485, -0.01354663],
    [0.0, 0.0, 0.0, 1.0],
]


@dataclass
class VioOptions:
    """Flat options mirroring VioManagerOptions.h:53-268."""

    # estimator (uzhfpv.launch:17-19,66-67; VioManager.cpp)
    init_window_time: float = 1.0
    init_imu_thresh: float = 0.5
    init_height: float = 0.1
    max_iekf_iterations: int = 1
    gravity_mag: float = 9.81
    calib_camimu_dt: float = -0.0148489  # uzhfpv.launch:43

    # noise (NoiseManager defaults overridden by uzhfpv.launch:70-74)
    gyroscope_noise_density: float = 0.00559017
    gyroscope_random_walk: float = 8.94427e-04
    accelerometer_noise_density: float = 0.01118034
    accelerometer_random_walk: float = 0.04472136
    # variance multiplier on the whole 15x15 Q and the extra position
    # process-noise term (the hardcoded 1e-4*I of Propagator.h:97). The
    # launch sigmas model SENSOR noise; the network measurement model also
    # violates its assumptions (non-planar scene patches, rolling texture
    # parallax, time discretization), and the replay-calibrated scale that
    # keeps the filter consistent under those model errors is well above 1
    # (eval/tuning.py sweep, round 3).
    process_noise_scale: float = 1.0
    extra_position_noise: float = 1.0e-4

    # updater (UpdaterOptions.h:33, uzhfpv.launch:65)
    up_linear_k_hnet_cov: float = 10.0
    update_gate_frames: int = 10  # VioManager.cpp:257
    # chi-square(8) Mahalanobis catastrophe gate on the innovation (new vs
    # the reference, which has no outlier rejection — filter/update.py)
    chi2_gate: float = 1000.0
    # --- correlated-measurement-error model (round 5, filter/state.py
    # FilterState docstring; no reference counterpart — the reference's
    # white-noise R is exactly what its never-validated covariance assumes).
    # OU measurement-bias stationary std-dev in PIXELS (0 disables the
    # 8-state augmentation) and correlation time in seconds:
    meas_bias_sigma_px: float = 0.0
    meas_bias_tau: float = 2.0
    # soft innovation threshold for adaptive R inflation (0 disables):
    chi2_soft: float = 0.0
    # prior-echo fraction of the prior-mode network (FilterParams.echo_beta;
    # measured ~0.5 on the replay by regressing corner-flow error against
    # fed-prior error; 0 = reference's echo-blind model):
    echo_beta: float = 0.0

    # network (uzhfpv.launch:56-59)
    use_network: bool = True
    use_prior: bool = True
    blocks_to_run: int = 3
    mc_dropout: float = 0.05
    network_weights_path: Optional[str] = None
    show_error_map: bool = False

    # camera (uzhfpv.launch:77-94); raw-image undistortion parameters
    cam_width: int = 640
    cam_height: int = 480
    cam_is_fisheye: bool = True
    cam_intrinsics: List[float] = field(
        default_factory=lambda: [
            275.46015578667294, 274.9948095922592, 315.958384100568, 242.7123497822731,
        ]
    )
    cam_distortion: List[float] = field(
        default_factory=lambda: [
            -6.545154718304953e-06, -0.010379525898159981,
            0.014935312423953146, -0.005639061406567785,
        ]
    )
    t_imu_to_cam: List[List[float]] = field(
        default_factory=lambda: [row[:] for row in T_ITOC_INDOOR45]
    )
    require_undistortion: bool = True

    # runtime
    record_timing: bool = False
    max_imu_steps_per_frame: int = 64

    # ------------------------------------------------------------- factories
    @classmethod
    def uzhfpv_indoor45(cls) -> "VioOptions":
        return cls()

    def apply_profile(self, name: str) -> "VioOptions":
        """Return a copy with a named tuning profile applied.

        ``launch``: the reference's shipped launch-file operating point,
        bit-identical to uzhfpv.launch (the dataclass defaults).

        ``calibrated``: the replay-calibrated operating point (eval/tuning.py
        vmapped sweep + real-run confirmation, rounds 3-4). The launch sigmas
        model SENSOR noise only; the network measurement model additionally
        violates its own assumptions (non-planar scene patches, texture
        parallax, discretization), so the innovation-consistent process noise
        is well above the datasheet values, and the innovation-chi2-fitted
        measurement temperature is below the reference's hand-tuned
        K_net_Cov=10 (UpdaterOptions.h:33). This is the profile the shipped
        benchmarks run; CALIBRATED_PROFILE records the exact numbers.
        """
        if name == "launch":
            return dataclasses.replace(self, **LAUNCH_PROFILE)
        if name == "calibrated":
            return dataclasses.replace(self, **{**LAUNCH_PROFILE, **CALIBRATED_PROFILE})
        raise ValueError(f"unknown profile {name!r} (launch|calibrated)")

    @classmethod
    def uzhfpv_outdoor45(cls) -> "VioOptions":
        t = np.linalg.inv(np.asarray(T_C0TOI_OUTDOOR45))
        return cls(
            cam_intrinsics=[
                275.3385453506587, 275.0852058534152,
                315.7697752181792, 233.72625444124952,
            ],
            cam_distortion=[
                -0.017811595366268803, 0.04897078939103475,
                -0.041363300782847834, 0.011440891936886532,
            ],
            t_imu_to_cam=[list(map(float, row)) for row in t],
        )

    @classmethod
    def from_yaml(cls, path: str) -> "VioOptions":
        with open(path) as f:
            data = yaml_io.load(f.read())
        valid = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - valid
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**data)

    def to_yaml(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(yaml_io.dump(dataclasses.asdict(self)))

    # ----------------------------------------------------------- converters
    def filter_params(self, device="cuda") -> FilterParams:
        return make_params(
            np.asarray(self.t_imu_to_cam),
            gravity_mag=self.gravity_mag,
            sigma_w=self.gyroscope_noise_density,
            sigma_a=self.accelerometer_noise_density,
            sigma_wb=self.gyroscope_random_walk,
            sigma_ab=self.accelerometer_random_walk,
            k_net_cov=self.up_linear_k_hnet_cov,
            chi2_gate=self.chi2_gate,
            q_scale=self.process_noise_scale,
            extra_pos_noise=self.extra_position_noise,
            bias_sigma_px=self.meas_bias_sigma_px,
            bias_tau=self.meas_bias_tau,
            chi2_soft=self.chi2_soft if self.chi2_soft > 0 else float("inf"),
            echo_beta=self.echo_beta,
            device=device,
        )

    def vio_config(self) -> VioConfig:
        return VioConfig(
            max_iekf_iterations=self.max_iekf_iterations,
            use_prior=self.use_prior,
            update_gate_frames=self.update_gate_frames,
            blocks_to_run=self.blocks_to_run,
        )

    def runner_options(self) -> RunnerOptions:
        return RunnerOptions(
            calib_camimu_dt=self.calib_camimu_dt,
            init_window_time=self.init_window_time,
            init_imu_thresh=self.init_imu_thresh,
            init_height=self.init_height,
            gravity_mag=self.gravity_mag,
            max_imu_steps_per_frame=self.max_imu_steps_per_frame,
        )
