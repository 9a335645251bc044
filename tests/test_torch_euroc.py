"""The port's EuRoC-ASL ingestion (``cuahn_vio_torch.data.euroc``, the
``convert-euroc``, ``distort-to-euroc`` and ``format-converter`` verbs)
against the JAX package's, on the same seeded inputs, on the CPU.

Tolerances: ``write_euroc_dir`` writes the same csv bytes and PNGs of the
same pixels; ``load_euroc_sequence`` gives the JAX package's frames bit
for bit (the same map and the remap's fma arithmetic, ``test_torch_runtime``)
and its IMU exactly; ``distort_frames_to_raw`` computes its blend in
float32 where the JAX function computes it in float64 numpy, so at least
99.9 % of the raw pixels are equal and none is more than one level apart;
the dead-reckoning ``convert-euroc -> run-vio`` chain's ATE is within
0.005 m of the JAX chain's.
"""

import os

import numpy as np
import pytest
import torch

from cuahn_vio import cli as jcli
from cuahn_vio.data import euroc as jeuroc
from cuahn_vio_torch import cli as tcli
from cuahn_vio_torch.data import euroc as teuroc
from cuahn_vio_torch.data.synthetic import AnalyticTrajectory, make_sequence
from cuahn_vio_torch.eval.traj_io import save_pose_file
from cuahn_vio_torch.utils.config import VioOptions

Image = pytest.importorskip("PIL.Image")

UZH_K = [275.46015578667294, 274.9948095922592, 315.958384100568, 242.7123497822731]
UZH_D = [-6.545154718304953e-06, -0.010379525898159981, 0.014935312423953146,
         -0.005639061406567785]
EUROC_K = [458.654, 457.296, 367.215, 248.375]
EUROC_D = [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]


def _raw_frames(rng, n: int, h: int = 480, w: int = 640) -> np.ndarray:
    """Camera-like raw frames: smooth structure, noise and dark corners."""
    y, x = np.mgrid[0:h, 0:w]
    base = 128 + 60 * np.sin(x / 23.0) * np.cos(y / 17.0)
    frames = base[None] + rng.normal(0, 12, (n, h, w))
    frames[:, :40, :60] = 0
    return np.clip(frames, 0, 255).astype(np.uint8)


def _imu(rng, n: int):
    t = 1.5 + np.arange(n) * 0.002
    return t, rng.normal(0, 0.3, (n, 3)), rng.normal(0, 2.0, (n, 3)) + [0, 0, 9.81]


def _read_dir(root: str):
    cam = os.path.join(root, "mav0", "cam0")
    names = sorted(os.listdir(os.path.join(cam, "data")))
    imgs = [np.asarray(Image.open(os.path.join(cam, "data", n))) for n in names]
    csvs = [open(os.path.join(root, "mav0", p, "data.csv"), "rb").read()
            for p in ("imu0", "cam0")]
    return names, imgs, csvs


def test_write_euroc_dir_matches_jax(rng, tmp_path):
    frames = _raw_frames(rng, 3)
    imu_t, imu_w, imu_a = _imu(rng, 40)
    cam_t = np.array([1.5, 1.5333333, 1.5666667])
    teuroc.write_euroc_dir(str(tmp_path / "t"), frames, imu_t, imu_w, imu_a, cam_t)
    jeuroc.write_euroc_dir(str(tmp_path / "j"), frames, imu_t, imu_w, imu_a, cam_t)
    t_names, t_imgs, t_csv = _read_dir(str(tmp_path / "t"))
    j_names, j_imgs, j_csv = _read_dir(str(tmp_path / "j"))
    assert t_names == j_names and t_csv == j_csv
    for a, b in zip(t_imgs, j_imgs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k, d, fisheye", [(UZH_K, UZH_D, True), (EUROC_K, EUROC_D, False)],
                         ids=["fisheye", "radtan"])
def test_load_euroc_sequence_matches_jax(k, d, fisheye, rng, tmp_path):
    """The JAX package's own directory (PIL's PNGs, filters chosen per
    row) through both loaders."""
    frames = _raw_frames(rng, 4)
    imu_t, imu_w, imu_a = _imu(rng, 60)
    cam_t = 1.5 + np.arange(4) / 30.0
    jeuroc.write_euroc_dir(str(tmp_path), frames, imu_t, imu_w, imu_a, cam_t)
    want = jeuroc.load_euroc_sequence(str(tmp_path), np.asarray(k), np.asarray(d), fisheye,
                                      max_frames=3)
    got = teuroc.load_euroc_sequence(str(tmp_path), np.asarray(k), np.asarray(d), fisheye,
                                     max_frames=3, device="cpu")
    assert got.frames.shape == (3, 224, 320) and got.frames.dtype == np.uint8
    np.testing.assert_array_equal(got.frames, want.frames)
    for name in ("imu_t", "imu_w", "imu_a", "cam_t"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def _rendered(n_frames: int, seed: int = 3, duration: float = 0.5):
    opts = VioOptions.uzhfpv_indoor45()
    seq = make_sequence(AnalyticTrajectory(), np.asarray(opts.t_imu_to_cam), duration=duration,
                        t_still=1.0, seed=seed, sigma_w=0.001, sigma_a=0.01, bias_g=0.001,
                        bias_a=0.005, device="cpu")
    return seq, seq.frames[:n_frames]


@pytest.mark.parametrize("k, d, fisheye", [(UZH_K, UZH_D, True), (EUROC_K, EUROC_D, False)],
                         ids=["fisheye", "radtan"])
def test_distort_frames_to_raw_matches_jax(k, d, fisheye):
    _, frames = _rendered(3)
    want = jeuroc.distort_frames_to_raw(frames, list(k), list(d), fisheye)
    got = teuroc.distort_frames_to_raw(frames, list(k), list(d), fisheye, device="cpu")
    assert got.shape == want.shape == (3, 480, 640) and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert (diff == 0).mean() >= 0.999 and diff.max() <= 1


def _write_sequence(path, seq):
    np.savez_compressed(path, imu_t=seq.imu_t, imu_w=seq.imu_w, imu_a=seq.imu_a,
                        cam_t=seq.cam_t, frames=seq.frames)


def _config(path, seq):
    opts = VioOptions.uzhfpv_indoor45().apply_profile("calibrated")
    opts.calib_camimu_dt = 0.0
    opts.init_height = float(seq.gt_pose_w[0, 2])
    opts.init_imu_thresh = 0.2
    opts.to_yaml(path)


def test_raw_camera_verbs_and_chain_match_jax(tmp_path):
    """``distort-to-euroc``, ``convert-euroc`` and dead-reckoning ``run-vio``
    of both packages on one short sequence (1 s still, 1.5 s of flight):
    raw frames within a level, converted frames bit for bit from one raw
    directory, the chain's ATE within 0.005 m."""
    seq, _ = _rendered(0, seed=5, duration=1.5)
    p = lambda name: str(tmp_path / name)  # noqa: E731
    _write_sequence(p("seq.npz"), seq)
    save_pose_file(p("seq_gt.txt"), seq.gt_times, seq.gt_pose_w)
    _config(p("cfg.yaml"), seq)

    tcli.main(["distort-to-euroc", p("seq.npz"), "--out", p("t_raw"), "--config", p("cfg.yaml"),
               "--device", "cpu"])
    jcli.main(["distort-to-euroc", p("seq.npz"), "--out", p("j_raw"), "--config", p("cfg.yaml")])
    t_names, t_imgs, t_csv = _read_dir(p("t_raw"))
    j_names, j_imgs, j_csv = _read_dir(p("j_raw"))
    assert t_names == j_names and t_csv == j_csv and len(t_imgs) == len(seq.cam_t)
    diff = np.abs(np.stack(t_imgs).astype(int) - np.stack(j_imgs).astype(int))
    assert (diff == 0).mean() >= 0.999 and diff.max() <= 1

    # both converters on the JAX package's raw directory: bit for bit
    tcli.main(["convert-euroc", p("j_raw"), "--out", p("t.npz"), "--config", p("cfg.yaml"),
               "--device", "cpu"])
    jcli.main(["convert-euroc", p("j_raw"), "--out", p("j.npz"), "--config", p("cfg.yaml")])
    t_seq, j_seq = np.load(p("t.npz")), np.load(p("j.npz"))
    assert sorted(t_seq.files) == sorted(j_seq.files)
    for name in j_seq.files:
        np.testing.assert_array_equal(t_seq[name], j_seq[name])
    rmse = np.sqrt(np.mean((t_seq["frames"][:, 40:180, 60:260].astype(float)
                            - seq.frames[:, 40:180, 60:260]) ** 2))
    assert rmse <= 6.0  # the interior round-trips (tests/test_euroc_e2e.py's bound)

    # each package's chain from its own raw directory
    tcli.main(["convert-euroc", p("t_raw"), "--out", p("t_own.npz"), "--config", p("cfg.yaml"),
               "--device", "cpu"])
    tcli.main(["run-vio", p("t_own.npz"), "--config", p("cfg.yaml"), "--no-network",
               "--device", "cpu", "--out", p("t_est.txt")])
    jcli.main(["run-vio", p("j.npz"), "--config", p("cfg.yaml"), "--no-network",
               "--out", p("j_est.txt")])
    from cuahn_vio.eval import ResultTrajectory

    ates = [ResultTrajectory.from_files(p(est), p("seq_gt.txt"), "se3").calculate_ate()[1].rmse
            for est in ("t_est.txt", "j_est.txt")]
    assert np.isfinite(ates).all() and abs(ates[0] - ates[1]) <= 0.005, ates


@pytest.mark.parametrize("first", ["txt", "csv"])
def test_format_converter_matches_jax(first, rng, tmp_path):
    n = 50
    t = 12.25 + np.arange(n) * 0.002
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    poses = np.concatenate([rng.normal(0, 2, (n, 3)), q], axis=1)
    src = str(tmp_path / f"in.{first}")
    if first == "txt":
        save_pose_file(src, t, poses)
    else:
        from cuahn_vio_torch.eval.traj_io import Trajectory, save_euroc_csv

        save_euroc_csv(src, Trajectory(t, poses, None, None))
    other = "csv" if first == "txt" else "txt"
    tcli.main(["format-converter", src, str(tmp_path / f"t.{other}")])
    jcli.main(["format-converter", src, str(tmp_path / f"j.{other}")])
    assert ((tmp_path / f"t.{other}").read_bytes() == (tmp_path / f"j.{other}").read_bytes())
    if first == "txt":  # and back: the csv keeps the pose txt's precision
        tcli.main(["format-converter", str(tmp_path / "t.csv"), str(tmp_path / "back.txt")])
        assert (tmp_path / "back.txt").read_bytes() == open(src, "rb").read()


def test_gt_state_lookup_matches_jax(rng, tmp_path):
    from cuahn_vio.data.gt_loader import get_gt_state as jget
    from cuahn_vio.data.gt_loader import load_gt_file as jload
    from cuahn_vio_torch.data.gt_loader import get_gt_state, load_gt_file

    t = np.sort(rng.uniform(0, 5, 200))
    poses = np.concatenate([rng.normal(size=(200, 3)), np.tile([0, 0, 0, 1.0], (200, 1))], 1)
    path = str(tmp_path / "gt.txt")
    save_pose_file(path, t, poses)
    mine, ref = load_gt_file(path), jload(path)
    np.testing.assert_array_equal(mine.times, ref.times)
    for stamp in [*rng.uniform(-0.1, 5.1, 40), float(mine.times[7])]:
        a, b = get_gt_state(mine, stamp), jget(ref, stamp)
        assert (a is None) == (b is None)
        if a is not None:
            assert a[0] == b[0] and np.array_equal(a[1], b[1])


def test_convert_euroc_runs_on_the_card_by_default():
    """``convert-euroc`` and ``distort-to-euroc`` default to ``--device
    cuda`` like the port's other verbs."""
    parser = tcli.build_parser()
    for argv in (["convert-euroc", "root"], ["distort-to-euroc", "s.npz", "--out", "o"]):
        assert parser.parse_args(argv).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            tcli.main(["convert-euroc", "root"])
