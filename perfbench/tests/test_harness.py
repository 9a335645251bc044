"""The harness on the CPU: files found by name, the yardstick's counts,
the loaded-module check and the reference's independence."""

import json
import os
import subprocess
import sys

import pytest

from perfbench.lib import counts, harness

ROOT = harness.ROOT
BENCH = harness.read_json(ROOT, "BENCHMARK.json")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    spec = harness.cell_spec(cell)
    assert os.path.exists(os.path.join(harness.BENCH_DIR, "work",
                                       f"{spec.traffic['work']}.py"))
    assert {m["name"] for m in spec.end_to_end} >= {"setup_s"}
    assert len(spec.end_to_end) >= 2 and spec.per_layer
    for m in spec.end_to_end + spec.per_layer:
        reader = harness.load_file(os.path.join(harness.BENCH_DIR, "metrics", f"{m['name']}.py"),
                                   "t_" + m["name"].replace(".", "_"))
        assert callable(reader.read)


def test_metrics_move_reported_end_to_end():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])


def test_config_files_state_their_source():
    for c in BENCH["configs"]:
        cfg = harness.read_json(ROOT, c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(ROOT, cfg["weights"]))


def test_profile_is_the_programs():
    """The filter numbers the reference reads are the program's profile."""
    from cuahn_vio_torch.utils.config import VioOptions

    cfg = harness.read_json(ROOT, "perfbench/configs/cuahn-vio-uzhfpv.json")
    opts = VioOptions.uzhfpv_indoor45().apply_profile(cfg["profile"])
    for k, v in cfg["filter"].items():
        assert getattr(opts, k) == v, k
    assert opts.t_imu_to_cam == cfg["t_imu_to_cam"]
    assert opts.calib_camimu_dt == cfg["calib_camimu_dt"]


def test_counts_by_hand():
    # prior mode at 224x320: blocks 2-4's convolutions 0.928 GFLOP a pair,
    # block 4's 416 MFLOP, the two 16-member heads 84 MFLOP
    prior = sum(counts.tower_flops(b, 224, 320) for b in ("block2", "block3", "block4"))
    assert prior == 927_784_960
    assert counts.tower_flops("block4", 224, 320) == 415_825_920
    # block 4's first conv: 224 x 320 x 8 outputs of 2 x 7 x 7 taps
    assert 2 * 224 * 320 * 8 * 2 * 49 == 112_394_240
    assert counts.head_flops(224, 320) == 2 * 16 * 2 * (5120 * 256 + 256 * 8)
    assert counts.fc_input(224, 320) == 5120
    # B2 at B = 64 uint8: images and homographies in, float32 out
    assert counts.warp_bytes(64, 224, 320, 1) == 64 * (71680 + 36) + 64 * 71680 * 4
    # T1: threefry's 41 ALU-only operations a value and the coin's 2 bound
    # it on the ALU pipe (64 lanes), its 32 adds all on the IMAD pipe
    assert counts.t1_function_clocks("bernoulli") == 43 / 64
    peaks = counts.PEAKS["NVIDIA H100 80GB HBM3"]
    assert counts.t1_bound_s("bernoulli", 11_010_048, peaks) * 1e3 == pytest.approx(0.028303,
                                                                                      rel=1e-4)


@pytest.mark.parametrize("name,refused", [
    ("jax", True), ("jaxlib", True), ("flax", True), ("optax", True), ("cuahn_vio", True),
    ("jax.numpy", True), ("cuahn_vio.models", True),
    ("cuahn_vio_torch", False), ("cuahn_vio_torch.models", False), ("jaxtyping", False),
])
def test_loaded_module_check(name, refused, monkeypatch):
    monkeypatch.setitem(sys.modules, name, object())
    assert (name.split(".")[0] in harness.forbidden_modules()) == refused


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import perfbench.reference.uahn, perfbench.lib.counts, "
            "perfbench.lib.scene, perfbench.lib.flax_msgpack, "
            "perfbench.lib.threefry, perfbench.lib.trace; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & {"cuahn_vio_torch", "cuahn_vio", "jax", "jaxlib", "flax", "optax"}
