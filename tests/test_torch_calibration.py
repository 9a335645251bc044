"""The port's covariance fits (``cuahn_vio_torch.eval.calibration``) and
their verbs against the JAX package's, on logs built from a seed.

Both sides are numpy: the fits must be equal, or within 1e-12 relative
where the summation order differs. The verbs print the JAX verbs' lines.
``calibrate-state-covariance`` refuses a log whose covariance ``run-vio
--cov-calib`` already inflated (the port's ``--state-out`` npz records the
factors; the JAX verb cannot tell).
"""

import numpy as np
import pytest

from cuahn_vio import cli as jcli
from cuahn_vio.eval import calibration as jcal
from cuahn_vio.eval.simulation import StateGT, save_state_gt
from cuahn_vio_torch import cli as tcli
from cuahn_vio_torch.eval import calibration as tcal

REL_TOL = 1e-12


def _spd(rng, f, n, scale):
    a = rng.normal(size=(f, n, n))
    return (a @ a.transpose(0, 2, 1) + n * np.eye(n)) * scale


def _innovation_log(seed, f=240):
    """(net_inno, cov_meas, net_cov88) as ``run-vio --state-out`` logs them,
    with gated rows (all zero) and non-finite rows among them."""
    rng = np.random.default_rng(seed)
    net_cov88 = _spd(rng, f, 8, 0.3).astype(np.float32)
    cov_meas = _spd(rng, f, 8, 2e-6).astype(np.float32)
    s = cov_meas + 10.0 * net_cov88 / tcal.FOCAL2
    inno = np.einsum("fij,fj->fi", np.linalg.cholesky(s), rng.standard_t(4, (f, 8)))
    inno = (inno * rng.uniform(0.5, 3.0)).astype(np.float32)
    net_cov88[:12] = 0.0  # gated / pre-update frames
    inno[12:15, 3] = np.nan
    cov_meas[15, 0, 0] = np.inf
    return inno, cov_meas, net_cov88


def _close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= REL_TOL * max(abs(want[k]), 1e-300), (k, got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_k_net_cov_matches_jax(seed):
    inno, cov_meas, net_cov88 = _innovation_log(seed)
    for k in (0.1, 10.0, 1e3):
        np.testing.assert_array_equal(tcal.chi2_for_k(inno[20:], cov_meas[20:], net_cov88[20:], k),
                                      jcal.chi2_for_k(inno[20:], cov_meas[20:], net_cov88[20:], k))
    np.testing.assert_array_equal(tcal._valid_rows(inno, cov_meas, net_cov88),
                                  jcal._valid_rows(inno, cov_meas, net_cov88))
    for kw in ({}, {"target_median": 3.0}, {"target_median": 1e-9}, {"target_median": 1e9}):
        _close(tcal.fit_k_net_cov(inno, cov_meas, net_cov88, **kw),
               jcal.fit_k_net_cov(inno, cov_meas, net_cov88, **kw))


def test_fit_k_net_cov_refuses_a_short_log():
    inno, cov_meas, net_cov88 = _innovation_log(0, f=20)
    with pytest.raises(ValueError, match="usable frames"):
        tcal.fit_k_net_cov(inno, cov_meas, net_cov88)


def _state_files(tmp_path, seed, factors=None):
    """A 17-column state GT (200 Hz, 4 s) and a ``--state-out`` npz at
    30 Hz: the estimate is the GT with noise, its (15, 15) covariance a
    random SPD stack (``factors``: inflated as ``run-vio --cov-calib``
    does, and recorded as the port records it)."""
    rng = np.random.default_rng(seed)
    t = np.arange(800) * 0.005
    pos = np.stack([np.sin(0.7 * t), 0.3 * t, 1.5 + 0.1 * np.cos(t)], 1)
    vel = np.gradient(pos, t, axis=0)
    half = 0.5 * np.stack([0.05 * np.sin(t), 0.04 * np.cos(1.3 * t), 0.2 * t], 1)
    ang = np.linalg.norm(half, axis=1, keepdims=True)
    quat = np.concatenate([np.sin(ang) * half / ang, np.cos(ang)], 1)  # xyzw
    gt = StateGT(times=t, pose=np.concatenate([pos, quat], 1), vel=vel,
                 bg=np.tile([0.003, -0.002, 0.001], (len(t), 1)),
                 ba=np.tile([0.02, 0.01, -0.01], (len(t), 1)))
    gt_path = str(tmp_path / f"gt{seed}.txt")
    save_state_gt(gt_path, gt)
    k = np.arange(40, len(t), 7)
    f = len(k)
    est_q = quat[k] + rng.normal(0, 0.004, (f, 4))
    est_q /= np.linalg.norm(est_q, axis=1, keepdims=True)
    cov = _spd(rng, f, 15, 1e-5)
    est = dict(
        times=t[k], pose=np.concatenate([pos[k] + rng.normal(0, 0.02, (f, 3)), est_q], 1),
        v_body=vel[k] + rng.normal(0, 0.03, (f, 3)), ba=gt.ba[k] + rng.normal(0, 0.01, (f, 3)),
        bg=gt.bg[k] + rng.normal(0, 0.001, (f, 3)), cov_core=cov.astype(np.float32))
    if factors is not None:
        est["cov_core"] = tcal.apply_cov_inflation(est["cov_core"], factors)
        est.update(cov_calib_blocks=np.array(tcal.COV_BLOCKS), cov_calib_factors=np.array(
            [factors.get(name, 1.0) for name in tcal.COV_BLOCKS]))
    est["cov_diag"] = np.einsum("fii->fi", est["cov_core"])
    npz = str(tmp_path / f"state{seed}.npz")
    np.savez(npz, **est)
    return npz, gt_path


@pytest.mark.parametrize("seed", [0, 1])
def test_fit_cov_inflation_matches_jax(tmp_path, seed):
    npz, gt_path = _state_files(tmp_path, seed)
    want = jcal.fit_cov_inflation(npz, gt_path)
    _close(tcal.fit_cov_inflation(npz, gt_path), want)
    kw = dict(targets={"height": 2.0, "tilt": 1.0, "vel": 2.5}, iters=2)
    _close(tcal.fit_cov_inflation(npz, gt_path, **kw), jcal.fit_cov_inflation(npz, gt_path, **kw))


def _verb_lines(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out.splitlines()


def test_calibrate_covariance_prints_the_jax_lines(tmp_path, capsys):
    inno, cov_meas, net_cov88 = _innovation_log(3)
    path = str(tmp_path / "log.npz")
    np.savez(path, net_inno=inno, cov_meas=cov_meas, net_cov88=net_cov88)
    for extra in ([], ["--target-median", "5.0"]):
        argv = ["calibrate-covariance", path, *extra]
        assert _verb_lines(tcli.main, argv, capsys) == _verb_lines(jcli.main, argv, capsys)
    np.savez(path, net_inno=inno)
    with pytest.raises(ValueError, match="lacks 'cov_meas'"):
        tcli.main(["calibrate-covariance", path])


def test_calibrate_state_covariance_prints_the_jax_lines(tmp_path, capsys):
    npz, gt_path = _state_files(tmp_path, 4)
    argv = ["calibrate-state-covariance", npz, gt_path]
    got = _verb_lines(tcli.main, argv, capsys)
    assert got == _verb_lines(jcli.main, argv, capsys)
    assert got[1].startswith("run-vio flag:  --cov-calib pos:")


def test_calibrate_state_covariance_refuses_an_inflated_log(tmp_path, capsys):
    """A log written with ``--cov-calib`` exits non-zero naming its
    factors; the same run without them is fitted."""
    factors = {"pos": 2.0, "ori": 3.0, "vel": 1.5}
    npz, gt_path = _state_files(tmp_path, 5, factors)
    assert tcal.recorded_inflation(np.load(npz)) == dict(factors, ba=1.0, bg=1.0)
    with pytest.raises(SystemExit) as refused:
        tcli.main(["calibrate-state-covariance", npz, gt_path])
    message = str(refused.value.code)
    assert "already inflated" in message and "'ori': 3.0" in message and "'pos': 2.0" in message
    plain, _ = _state_files(tmp_path, 6)
    assert tcal.recorded_inflation(np.load(plain)) is None
    tcli.main(["calibrate-state-covariance", plain, gt_path])
    assert "fitted observable-NEES inflation factors" in capsys.readouterr().out
