"""The port's YAML reader and writer (``utils/yaml_io.py``) against PyYAML.

The writer must give ``yaml.safe_dump(asdict(opts), sort_keys=False)``
byte for byte; the reader must give ``yaml.safe_load`` of what PyYAML
writes and of configs typed in the same subset, and refuse the rest with
the line named. ``make-synthetic`` and ``run-vio --config`` must run with
PyYAML blocked.
"""

import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

from cuahn_vio.utils.config import VioOptions as JaxVioOptions
from cuahn_vio_torch.utils import yaml_io
from cuahn_vio_torch.utils.config import VioOptions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _synthetic_config():
    """The config make-synthetic writes (calibrated, the sequence's knobs)."""
    opts = VioOptions().apply_profile("calibrated")
    opts.calib_camimu_dt = 0.0
    opts.init_height = 1.5000001192092896
    opts.init_imu_thresh = 0.2
    return opts


PROFILES = {
    "default": VioOptions(),
    "launch": VioOptions().apply_profile("launch"),
    "calibrated": VioOptions().apply_profile("calibrated"),
    "make-synthetic": _synthetic_config(),
    "outdoor45": VioOptions.uzhfpv_outdoor45(),
    "weights, bias block, tiny and infinite floats": dataclasses.replace(
        VioOptions(), network_weights_path="/data/weights/uahn fil v10.msgpack",
        meas_bias_sigma_px=2.0, extra_position_noise=1e-5, chi2_soft=math.inf,
        process_noise_scale=1e17, gravity_mag=-0.0, use_prior=False),
}


@pytest.mark.parametrize("name", list(PROFILES))
def test_writer_equals_pyyaml_byte_for_byte(name, tmp_path):
    opts = PROFILES[name]
    data = dataclasses.asdict(opts)
    want = yaml.safe_dump(data, sort_keys=False)
    assert yaml_io.dump(data) == want
    path = tmp_path / "cfg.yaml"
    opts.to_yaml(str(path))
    assert path.read_text() == want


@pytest.mark.parametrize("name", list(PROFILES))
def test_reader_round_trips_and_reads_jax_written_configs(name, tmp_path):
    opts = PROFILES[name]
    text = yaml.safe_dump(dataclasses.asdict(opts), sort_keys=False)
    assert yaml_io.load(text) == yaml.safe_load(text)
    path = str(tmp_path / "cfg.yaml")
    opts.to_yaml(path)
    assert VioOptions.from_yaml(path) == opts
    # the JAX package's writer (PyYAML) and reader on the same options
    JaxVioOptions(**dataclasses.asdict(opts)).to_yaml(path)
    assert VioOptions.from_yaml(path) == opts
    opts.to_yaml(path)
    assert dataclasses.asdict(JaxVioOptions.from_yaml(path)) == dataclasses.asdict(opts)


def test_writer_and_reader_agree_with_pyyaml_on_random_scalars():
    """Random floats, ints, bools, None and strings, alone and in nested
    lists: whatever the writer accepts is PyYAML's text, and reads back as
    PyYAML reads it."""
    rng = np.random.default_rng(0)
    alphabet = list("abcxyzAZ019.-+eE:_ #'\"/[]{},&*!|>%@`~?=<")
    written = refused = 0
    for _ in range(4000):
        kind = rng.integers(6)
        if kind == 0:
            x = float(rng.normal() * 10.0 ** rng.integers(-30, 30))
        elif kind == 1:
            x = float(rng.choice([math.inf, -math.inf, 0.0, -0.0, 1e16, 1e17, 1e-5, 0.1]))
        elif kind == 2:
            x = int(rng.integers(-10**12, 10**12))
        elif kind == 3:
            x = [True, False, None][rng.integers(3)]
        else:
            x = "".join(rng.choice(alphabet, rng.integers(0, 10)))
        data = {"key": x, "a_list": [x, [x, 1.0], [2, x]]}
        try:
            text = yaml_io.dump(data)
        except yaml_io.YamlSubsetError:
            refused += 1
            continue
        written += 1
        assert text == yaml.safe_dump(data, sort_keys=False), repr(x)
        assert yaml_io.load(text) == yaml.safe_load(text), repr(x)
    assert written > 3000 and refused > 0


TYPED = """\
# a config typed by hand
init_height: 1.5      # metres
max_iekf_iterations: 2
use_prior: yes
show_error_map: Off
network_weights_path: 'weights/it''s v10.msgpack'   # quoted, with a quote
chi2_soft: .inf
extra_position_noise: 1.0e-05
meas_bias_tau: 2.5e+0
calib_camimu_dt: -0.0

cam_intrinsics:
  - 275.5
  - 274.9   # indented items
  - 315.9
  - 242.7
t_imu_to_cam:
-
  - 1.0
  - 0.0
- [BLOCK]
"""


def test_reader_reads_a_typed_config():
    text = TYPED.replace("- [BLOCK]\n", "- - 0.5\n  - +2\n- \"a \\\"b\\\"\"\n- ~\n")
    assert yaml_io.load(text) == yaml.safe_load(text)
    got = yaml_io.load(text)
    assert got["use_prior"] is True and got["show_error_map"] is False
    assert got["t_imu_to_cam"] == [[1.0, 0.0], [0.5, 2], 'a "b"', None]
    assert yaml_io.load("") == yaml_io.load("# nothing\n") == yaml_io.load("{}\n") == {}


OUTSIDE = {
    "flow list": "cam_intrinsics: [1.0, 2.0]\n",
    "flow mapping": "a: {b: 1}\n",
    "anchor": "a: &x 1.0\n",
    "alias": "a: *x\n",
    "tag": "a: !!float 1\n",
    "block scalar": "a: |\n  text\n",
    "folded scalar": "a: >\n  text\n",
    "multi-line quoted": "a: 'one\n  two'\n",
    "nested mapping": "a:\n  b: 1\n",
    "inline mapping": "a: b: 1\n",
    "exponent without a dot": "a: 1e-05\n",
    "plain inf": "a: inf\n",
    "signed fraction without a leading digit": "a: -.5\n",
    "octal": "a: 010\n",
    "hex": "a: 0x1f\n",
    "underscores": "a: 1_000\n",
    "sexagesimal": "a: 1:30\n",
    "date": "a: 2026-10-17\n",
    "merge key": "<<: 1\n",
    "document marker": "---\na: 1\n",
    "directive": "%YAML 1.1\na: 1\n",
    "duplicate key": "a: 1\na: 2\n",
    "tab indentation": "a:\n\t- 1\n",
    "escape": 'a: "x\\ty"\n',
    "text after quotes": "a: 'x' y\n",
    "bad indentation": "a:\n  - 1\n - 2\n",
    "key not an identifier": "a b: 1\n",
}


@pytest.mark.parametrize("name", list(OUTSIDE))
def test_reader_refuses_what_is_outside_the_subset(name):
    text = "init_height: 1.5\n" + OUTSIDE[name]
    with pytest.raises(yaml_io.YamlSubsetError, match=r"line \d"):
        yaml_io.load(text)


@pytest.mark.parametrize("value", [
    "multi\nline", "tab\there", "caf\u00e9", (1.0, 2.0), np.float64(1.0), {"nested": 1}, [],
    "1e-05", "x " * 40,
], ids=["newline", "tab", "non-ascii", "tuple", "numpy float", "mapping", "empty list",
        "number-like string", "wrapping string"])
def test_writer_refuses_what_is_outside_the_subset(value):
    with pytest.raises(yaml_io.YamlSubsetError):
        yaml_io.dump({"network_weights_path": value})


def test_from_yaml_refuses_unknown_keys(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text("init_height: 1.5\nnot_a_field: 1\n")
    with pytest.raises(ValueError, match="unknown config keys"):
        VioOptions.from_yaml(str(path))


NO_YAML = r'''
import importlib.abc
import sys


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "yaml":
            raise ImportError(f"blocked import of {name}")
        return None


sys.modules.pop("yaml", None)
sys.meta_path.insert(0, Block())
try:
    import yaml  # noqa: F401
except ImportError:
    pass
else:
    raise SystemExit("yaml was not blocked")

from cuahn_vio_torch import cli

cli.main(["make-synthetic", "--device", "cpu", "--out", "seq.npz", "--duration", "0.4"])
cli.main(["run-vio", "seq.npz", "--config", "seq_config.yaml", "--no-network",
          "--device", "cpu", "--out", "est.txt", "--timing-out", "t.csv"])
cli.main(["run-vio-batch", "seq.npz", "--config", "seq_config.yaml", "--no-network",
          "--device", "cpu", "--out-dir", "batch"])
assert "yaml" not in sys.modules
print("ok")
'''


def test_make_synthetic_and_run_vio_config_without_pyyaml(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", NO_YAML], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["batch", "est.txt", "seq.npz", "seq_config.yaml", "seq_gt.txt", "seq_state_gt.txt",
         "t.csv"])
    cfg = yaml.safe_load((tmp_path / "seq_config.yaml").read_text())
    assert cfg["init_imu_thresh"] == 0.2 and cfg["calib_camimu_dt"] == 0.0
    assert len(np.loadtxt(tmp_path / "est.txt")) == len(np.loadtxt(tmp_path / "t.csv",
                                                                   delimiter=","))
