"""The weightless verbs through both CLIs on the CPU, on
``tests/test_torch_run_vio_flags.py``'s 0.6 s sequence: neither
``--weights`` nor a config's network_weights_path, so both packages run
the network of ``init_uahn(PRNGKey(0))`` (``tests/test_torch_init.py``
holds the port's to the JAX one), MC dropout at seed 0 (the same masks).

- ``run-vio``: the same poses within that file's POS_ATOL + FILE_STEP
  (quaternions Q_ATOL + FILE_STEP);
- ``inspect-frame``: the printed flow and covariance diagonal within 1e-3
  (the JAX verb prints 3 decimals).
"""

import numpy as np
import torch

from cuahn_vio.cli import main as jax_main
from cuahn_vio.eval.traj_io import load_pose_file
from cuahn_vio_torch import cli as tcli
from tests.test_torch_run_vio_flags import FILE_STEP, POS_ATOL, Q_ATOL
from tests.test_torch_run_vio_flags import files  # noqa: F401 (a fixture)

# the suite runs in several worker processes: keep torch to a few threads
torch.set_num_threads(2)


def _printed(text: str, label: str) -> np.ndarray:
    line = next(line for line in text.splitlines() if line.startswith(label))
    return np.array(line.split("[", 1)[1].rstrip("]").split(), dtype=np.float64)


def test_inspect_frame_without_weights_prints_the_jax_verbs(files, tmp_path,  # noqa: F811
                                                           capsys):
    npz, _ = files
    jax_main(["inspect-frame", npz, "--frame", "3", "--out", str(tmp_path / "j.png")])
    jax_said = capsys.readouterr().out
    tcli.main(["inspect-frame", npz, "--frame", "3", "--out", str(tmp_path / "t.png"),
               "--device", "cpu"])
    said = capsys.readouterr().out
    for label in ("4pt flow (px):", "cov diag (px^2):"):
        np.testing.assert_allclose(_printed(said, label), _printed(jax_said, label),
                                   atol=1e-3 + 1e-9, rtol=0, err_msg=label)


def test_cli_run_vio_without_weights_matches_jax(files, tmp_path):  # noqa: F811
    """Neither ``--weights`` nor the config's network_weights_path: both
    verbs run the network of ``init_uahn(PRNGKey(0))`` (MC-dropout at seed
    0, the same masks)."""
    npz, cfg = files
    paths = {k: str(tmp_path / f"{k}.txt") for k in ("jax", "port")}
    jax_main(["run-vio", npz, "--config", cfg, "--out", paths["jax"]])
    tcli.main(["run-vio", npz, "--config", cfg, "--out", paths["port"], "--device", "cpu"])
    e, r = load_pose_file(paths["port"]), load_pose_file(paths["jax"])
    np.testing.assert_array_equal(e.times, r.times)
    assert len(e.times) > 5
    np.testing.assert_allclose(e.poses[:, :3], r.poses[:, :3], atol=POS_ATOL + FILE_STEP, rtol=0)
    np.testing.assert_allclose(e.poses[:, 3:], r.poses[:, 3:], atol=Q_ATOL + FILE_STEP, rtol=0)
