"""Each cell's run end to end at a tiny size on the CPU, with the
program's plain paths: sound, it comes out correct; with its timed path
broken underneath (the program's network wrapped by a fault), correct
comes out false. Card tests (``cuda``) read the control at the cell's
own size on the card."""

import time

import pytest
import torch

from perfbench.lib import harness
from perfbench.lib.faults import fault_hook
from perfbench.readings import readings

TINY = {  # traffic overrides
    "uahn-pairs64": {"batch": 2, "batches": 2, "check_calls": 2, "trace_units": 2},
}
CELLS = [w["name"] for w in harness.read_json(harness.ROOT, "BENCHMARK.json")["workloads"]]
SEED = 2**31 + 12345  # beyond 32 signed bits: seeds run up to a little over 2**31


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cell, trace):
    torch.set_num_threads(4)
    out = harness.run(cell, SEED, 0.5, trace, time.perf_counter(), device="cpu",
                      traffic_overrides=TINY[cell])
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    if not trace:
        assert out["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("fault", ["prior", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(cell, fault):
    torch.set_num_threads(4)
    hook = fault_hook(fault)
    out = harness.run(cell, SEED + 1, 0.5, False, time.perf_counter(), device="cpu",
                      traffic_overrides=TINY[cell], model_factory=hook)
    assert not out["correct"], out["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(card, cell):
    """The reference in TF32 in the program's place fails the cell's check
    on three seeds at the cell's own size; the program passes it."""
    for seed in (SEED + 7, SEED + 8, SEED + 9):
        r = readings(cell, seed, 1, control=True)
        assert all(v <= r["limits"][k] for k, v in r["program"].items()), r
        assert any(v > r["limits"][k] for k, v in r["control"].items()), r
