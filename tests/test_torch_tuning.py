"""The port's measurement replay and filter-parameter sweep against the
JAX package on the CPU.

- ``run_sequence_with_measurements`` on ``tests/test_e2e_filter.py``'s
  oracle sequence (true corner flows, 0.25 px² covariances), clean and
  noisy IMU: world positions within 1e-4 m (measured ~1e-5 over 115
  frames of an 8 s flight; the test flies 4 s), quaternions within 1e-5, the core covariance within 1e-5
  absolute (measured 3.7e-6 against a largest entry of 2.2e-3), chi2
  within 1e-3 relative + 1e-4 absolute (float32 ops in another order;
  XLA's scan runs the 64 padded dt = 0 steps, the port skips them).
- The six scalar knobs of ``FilterParams`` as Python floats and as 0-d
  tensors give the same bits, on the replay path and on ``run_offline``
  (``run-vio``'s path), with every knob away from its default.
- ``replay_measurements`` + ``score_sweep`` on a 16-point grid that moves
  all eight axes, and the ``tune-filter`` verb's stdout and ``--out``
  rows on a 16-point product grid, against the JAX functions and verb on
  a short ``make-synthetic`` sequence and its ``run-vio --state-out`` log
  (v10 weights): every row's keys and integers (``n_gated``) equal,
  ``ate_pos`` within ``ATE_POS_TOL_M`` = 1e-5 m (measured ~2e-7 m),
  ``ate_ori`` within 5e-3 deg (measured 1.0e-3: the rotation error of a
  ~5-10 deg alignment offset), the other floats within 1e-3 relative, the
  same ``inf`` pattern and the same order of rows wherever two rows'
  ``ate_pos`` are farther apart than ``ATE_POS_TOL_M``.
- The verb's leading-row trim: a log with one extra leading zero row
  gives the rows of the log without it, as the JAX verb does.
"""

import contextlib
import io
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuahn_vio import cli as jcli
from cuahn_vio.eval import tuning as jtune
from cuahn_vio.filter import make_params as jmake_params
from cuahn_vio.pipeline import prepare_sequence as jprepare
from cuahn_vio.pipeline.vio import VioConfig as JVioConfig
from cuahn_vio.pipeline.vio import run_sequence_with_measurements as jrun
from cuahn_vio.utils.config import VioOptions as JVioOptions
from cuahn_vio_torch import cli as tcli
from cuahn_vio_torch.eval import tuning as ttune
from cuahn_vio_torch.eval.traj_io import load_pose_file
from cuahn_vio_torch.filter.state import make_params, with_bias_block
from cuahn_vio_torch.pipeline.runner import RunnerOptions, prepare_sequence, run_offline
from cuahn_vio_torch.pipeline.vio import VioConfig, run_sequence_with_measurements
from cuahn_vio_torch.utils.config import VioOptions
from tests.test_e2e_filter import T_ITOC_SYN, _make, _oracle_measurements

# the suite runs in several worker processes: keep torch to a few threads
torch.set_num_threads(2)

POS_TOL_M = 1e-4
Q_TOL = 1e-5
COV_TOL = dict(rtol=0, atol=1e-5)
CHI2_TOL = dict(rtol=1e-3, atol=1e-4)
ATE_POS_TOL_M = 1e-5
ROW_TOL = {"ate_pos": dict(rtol=0, atol=ATE_POS_TOL_M), "ate_ori": dict(rtol=0, atol=5e-3)}
OTHER_TOL = dict(rtol=1e-3, atol=0)
WEIGHTS = "weights/uahn_fil_v10.msgpack"
KNOBS = ("k_net_cov", "chi2_gate", "bias_sigma", "bias_tau", "chi2_soft", "echo_beta")
# a 16-point grid that moves all eight axes
GRID16 = [
    dict(k_net_cov=k, chi2_gate=g, q_scale=q, q_pos_extra=qp, bias_sigma_px=bs, bias_tau=bt,
         chi2_soft=cs, echo_beta=eb)
    for k, g, q, qp, bs, bt, cs, eb in zip(
        [4.0, 7.9, 12.0, 20.0] * 4, [1000.0, 100.0, 30.0, 2.0] * 4,
        [0.5, 1.0, 2.0, 4.0, 4.0, 2.0, 1.0, 0.5] * 2, [1e-5, 1e-4] * 8,
        [0.0] * 4 + [0.5] * 4 + [0.0, 1.0] * 4, [2.0] * 8 + [0.5] * 8,
        [float("inf"), 20.0] * 4 + [5.0] * 8, [0.0] * 6 + [0.3] * 10)
]
CLI_GRID = ["--k-net-cov", "4,12", "--q-scale", "1,4", "--chi2-soft", "0,20",
            "--echo-beta", "0,0.3"]


@pytest.mark.parametrize("noisy", [False, True])
def test_run_sequence_with_measurements_follows_jax(noisy):
    kw = dict(sigma_w=2e-3, sigma_a=2e-2, bias_g=2e-3, bias_a=5e-3, seed=3) if noisy else {}
    traj, seq = _make(duration=4.0, **kw)
    opts = RunnerOptions(calib_camimu_dt=0.0, init_imu_thresh=0.2, init_height=1.5)
    jp = jmake_params(T_ITOC_SYN)
    _, js0, jwin, cam_used, _ = jprepare(seq.imu_t, seq.imu_w, seq.imu_a, seq.cam_t,
                                         seq.frames, opts, jp)
    flows = _oracle_measurements(traj, cam_used, jp)
    n = flows.shape[0]
    covs = np.tile(np.eye(8, dtype=np.float32) * 0.25, (n, 1, 1))
    _, jout = jrun(js0, jp, JVioConfig(), jnp.array(flows), jnp.array(covs), jnp.ones(n, bool),
                   jnp.array(jwin.w_mid), jnp.array(jwin.a_mid), jnp.array(jwin.dt))

    tp = make_params(T_ITOC_SYN, device="cpu")
    _, ts0, win, cam_used_t, _ = prepare_sequence(seq.imu_t, seq.imu_w, seq.imu_a, seq.cam_t,
                                                  seq.frames, opts, tp, device="cpu")
    np.testing.assert_array_equal(cam_used_t, cam_used)
    _, tout = run_sequence_with_measurements(
        ts0, tp, VioConfig(), torch.as_tensor(flows), torch.as_tensor(covs),
        torch.ones(n, dtype=torch.bool), torch.as_tensor(win.w_mid), torch.as_tensor(win.a_mid),
        torch.as_tensor(win.dt), win.n_used)
    np.testing.assert_allclose(tout.p_world.numpy(), np.asarray(jout.p_world), atol=POS_TOL_M,
                               rtol=0)
    np.testing.assert_allclose(tout.q.numpy(), np.asarray(jout.q), atol=Q_TOL, rtol=0)
    np.testing.assert_allclose(tout.cov_core.numpy(), np.asarray(jout.cov_core), **COV_TOL)
    np.testing.assert_allclose(tout.net_chi2.numpy(), np.asarray(jout.net_chi2), **CHI2_TOL)
    assert set(tout._fields) == set(jout._fields)
    for name in tout._fields:
        assert tuple(getattr(tout, name).shape) == np.asarray(getattr(jout, name)).shape, name


def _tensor_knobs(fp):
    return fp._replace(**{k: torch.tensor(getattr(fp, k), dtype=torch.float32) for k in KNOBS})


def test_float_and_tensor_knobs_give_the_same_bits():
    """Every knob away from its default, the bias block on: the replay
    path and ``run_offline`` without a network (``run-vio --no-network``'s
    path) give equal bytes; ``make_params`` keeps returning floats."""
    from cuahn_vio_torch.parallel.selftest import _filter_batch, _states0

    kw = dict(k_net_cov=7.9, chi2_gate=100.0, bias_sigma_px=0.5, bias_tau=2.0,
              chi2_soft=20.0, echo_beta=0.3, q_scale=30.0, extra_pos_noise=1e-2)
    fp = make_params(T_ITOC_SYN, device="cpu", **kw)
    assert all(type(getattr(fp, k)) is float for k in KNOBS)
    z, r, valid, w, a, dts = _filter_batch(np.random.default_rng(0), 1, 16, 5)
    s0 = _states0(1, "cpu")
    s0 = type(s0)(*(None if x is None else x[0] for x in s0))
    outs = []
    for p in (fp, _tensor_knobs(fp)):
        _, out = run_sequence_with_measurements(
            with_bias_block(s0, p), p, VioConfig(update_gate_frames=0),
            torch.as_tensor(z[0] * 20), torch.as_tensor(r[0]), torch.as_tensor(valid[0]),
            torch.as_tensor(w[0]), torch.as_tensor(a[0]), torch.as_tensor(dts[0]))
        outs.append(out)
    for name in outs[0]._fields:
        assert torch.equal(getattr(outs[0], name), getattr(outs[1], name)), name

    _, seq = _make(duration=2.0, sigma_w=2e-3, sigma_a=2e-2, seed=3)
    opts = RunnerOptions(calib_camimu_dt=0.0, init_imu_thresh=0.2, init_height=1.5)
    res = [run_offline(seq.imu_t, seq.imu_w, seq.imu_a, seq.cam_t, seq.frames, None, p,
                       VioConfig(), opts, device="cpu")
           for p in (fp, _tensor_knobs(fp))]
    np.testing.assert_array_equal(res[0].pose_w, res[1].pose_w)
    np.testing.assert_array_equal(res[0].cov_core, res[1].cov_core)


@pytest.fixture(scope="module")
def run_files(tmp_path_factory):
    """A 2 s make-synthetic flight (after the 2.5 s still) and its run-vio
    --state-out log with the v10 weights, both by the port on the CPU."""
    d = tmp_path_factory.mktemp("tune")
    path = lambda name: str(d / name)  # noqa: E731
    with contextlib.redirect_stdout(io.StringIO()):
        tcli.main(["make-synthetic", "--device", "cpu", "--out", path("seq.npz"), "--duration",
                   "2", "--sigma-w", "0.002", "--sigma-a", "0.02", "--bias-g", "0.003",
                   "--bias-a", "0.02"])
        tcli.main(["run-vio", path("seq.npz"), "--config", path("seq_config.yaml"),
                   "--weights", WEIGHTS, "--out", path("est.txt"), "--state-out",
                   path("st.npz"), "--device", "cpu"])
    return path


def _rows_agree(port_rows, jax_rows, ordered: bool):
    """Row for row by grid_index: the same keys, equal ints and strings,
    floats within their tolerance, inf where the JAX row has inf; with
    ``ordered`` the same order up to near-ties of ate_pos."""
    assert len(port_rows) == len(jax_rows)
    by_index = {r["grid_index"]: r for r in port_rows}
    for jr in jax_rows:
        tr = by_index[jr["grid_index"]]
        assert set(tr) == set(jr), (tr, jr)
        for key, want in jr.items():
            got = tr[key]
            if isinstance(want, float):
                assert math.isinf(got) == math.isinf(want), (key, got, want)
                if math.isfinite(want):
                    np.testing.assert_allclose(got, want, err_msg=key,
                                               **ROW_TOL.get(key, OTHER_TOL))
            else:
                assert got == want, (key, got, want)
    if ordered:
        ate = {r["grid_index"]: r["ate_pos"] for r in jax_rows}
        for i, (tr, jr) in enumerate(zip(port_rows, jax_rows)):
            if tr["grid_index"] != jr["grid_index"]:
                gap = abs(ate[tr["grid_index"]] - ate[jr["grid_index"]])
                assert gap <= ATE_POS_TOL_M, (i, tr, jr)


def test_replay_and_score_follow_jax(run_files):
    d = np.load(run_files("seq.npz"))
    log = np.load(run_files("st.npz"))
    gt = load_pose_file(run_files("seq_gt.txt"))
    args = (d["imu_t"], d["imu_w"], d["imu_a"], d["cam_t"], log["net_mean"], log["net_cov88"])
    jopts = JVioOptions.from_yaml(run_files("seq_config.yaml"))
    jgrid = [jtune.SweepConfig(**g) for g in GRID16]
    jouts, jtimes = jtune.replay_measurements(*args, jopts.filter_params(), jgrid,
                                              jopts.runner_options(), jopts.vio_config())
    jrows = jtune.score_sweep(jouts, jtimes, gt.times, gt.poses, None, jgrid)

    topts = VioOptions.from_yaml(run_files("seq_config.yaml"))
    tgrid = [ttune.SweepConfig(**g) for g in GRID16]
    touts, ttimes = ttune.replay_measurements(*args, topts.filter_params("cpu"), tgrid,
                                              topts.runner_options(), topts.vio_config())
    trows = ttune.score_sweep(touts, ttimes, gt.times, gt.poses, None, tgrid)
    np.testing.assert_array_equal(ttimes, jtimes)
    assert touts.p_world.shape == np.asarray(jouts.p_world).shape
    _rows_agree(trows, jrows, ordered=False)
    assert {r.get("n_gated") for r in jrows} != {None}


def _verb(main, argv) -> list:
    """The JSON rows a verb prints on stdout."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]


def _tune_argv(run_files, log: str, out: str) -> list:
    return ["tune-filter", run_files("seq.npz"), log, run_files("seq_gt.txt"), "--config",
            run_files("seq_config.yaml"), *CLI_GRID, "--out", out]


def _jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_tune_filter_verb_follows_jax(run_files, capsys):
    jtop = _verb(jcli.main, _tune_argv(run_files, run_files("st.npz"), run_files("j.jsonl")))
    ttop = _verb(tcli.main, _tune_argv(run_files, run_files("st.npz"), run_files("t.jsonl"))
                 + ["--device", "cpu"])
    assert "the sweep replays logged measurements open loop" in capsys.readouterr().err
    assert len(ttop) == len(jtop) == 10
    _rows_agree(ttop, jtop, ordered=True)
    _rows_agree(_jsonl(run_files("t.jsonl")), _jsonl(run_files("j.jsonl")), ordered=True)
    assert len(_jsonl(run_files("t.jsonl"))) == 16


def test_tune_filter_trims_one_extra_leading_zero_row(run_files):
    """A log with a measurement-free row before its first (same time): the
    trim drops it and the rows equal the plain log's (which
    ``test_tune_filter_verb_follows_jax`` holds to the JAX verb's)."""
    log = dict(np.load(run_files("st.npz")))
    padded = {k: np.concatenate([v[:1] * 0 if k != "times" else v[:1], v]) for k, v in log.items()}
    np.savez(run_files("padded.npz"), **padded)
    plain = _verb(tcli.main, _tune_argv(run_files, run_files("st.npz"), run_files("p1.jsonl"))
                  + ["--device", "cpu"])
    trimmed = _verb(tcli.main, _tune_argv(run_files, run_files("padded.npz"),
                                          run_files("p2.jsonl")) + ["--device", "cpu"])
    assert trimmed == plain
    assert _jsonl(run_files("p2.jsonl")) == _jsonl(run_files("p1.jsonl"))
