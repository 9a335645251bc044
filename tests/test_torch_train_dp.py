"""The port's trainer data-parallel over ``torch.distributed``, on the CPU.

Two OS processes join one job over a localhost TCP rendezvous (gloo, the
environment ``torch.distributed.run`` sets: MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK) and run ``train.trainer.train`` on the JAX sharded
test's model (``tests/test_train_sharded.py``: 56x80, batch 8, photo
textures and effects, 2 blur taps, 3 steps, MC dropout at its default),
4 rows a rank; a third process trains the same seed alone. The two ranks'
weights must be byte-identical, and within 1e-6 max abs of the one
process's (the ranks' gradient sums associate differently; with the
warmup's small first steps an unscaled echo term moves the weights by
~5e-6), and rank 0's logged lines (4 decimals) equal the one process's: the
losses are the global batch's. The same with the echo penalty on and
every step in prior mode. One ``all_reduce`` of the flat gradient runs a
step; only rank 0 writes checkpoints. A batch of 7 does not split over 2
ranks: both train unsharded, say why, and end bit-identical to one
process at batch 7. ``train-uahn`` under ``python -m
torch.distributed.run`` trains data-parallel with no new flag.

The rank binding of a CUDA job (``parallel.mesh.bind_rank_device``) is
tested with ``torch.cuda`` monkeypatched. Each subprocess is waited on
with a timeout, every process of a job killed on a timeout; the
rendezvous and every collective have their own 120 s timeout.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from cuahn_vio_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS_TOL = 1e-6

WORKER = r"""
import json, os, sys
import numpy as np, torch
import torch.distributed as dist

torch.set_num_threads(2)
from cuahn_vio_torch.models.uahn import init_uahn
from cuahn_vio_torch.utils import prng
from cuahn_vio_torch.parallel.mesh import init_distributed
from cuahn_vio_torch.train import trainer as T
from cuahn_vio_torch.utils.config import VioOptions

out, batch, echo, prior_prob = sys.argv[1], int(sys.argv[2]), float(sys.argv[3]), float(sys.argv[4])
init_distributed(device="cpu")  # a no-op without the job's environment
model = init_uahn(prng.prng_key(0), 56, 80, device="cpu")
n_params = sum(p.numel() for p in model.parameters())
flat_reduces = []
all_reduce = dist.all_reduce

def counted(tensor, *args, **kwargs):
    if tensor.numel() == n_params:
        flat_reduces.append(1)
    return all_reduce(tensor, *args, **kwargs)

dist.all_reduce = counted
t = np.asarray(VioOptions().t_imu_to_cam, np.float64)
cam = (torch.tensor(t[:3, :3], dtype=torch.float32),
       torch.tensor(-t[:3, :3].T @ t[:3, 3], dtype=torch.float32))
cfg = T.TrainConfig(batch_size=batch, use_textures=True, use_effects=True, blur_taps=2,
                    echo_weight=echo, prior_prob=prior_prob)
log = []
T.train(model, *cam, cfg, steps=3, seed=0, log_every=1, height=56, width=80,
        log_fn=lambda m, **_: log.append(m), checkpoint_path=out + ".msgpack", save_every=1,
        gt_dir=os.path.join(os.path.dirname(out), "no_gt"))
np.savez(out + ".npz", **{k: v.numpy() for k, v in model.state_dict().items()})
with open(out + ".json", "w") as f:
    json.dump({"log": log, "flat_reduces": len(flat_reduces)}, f)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(procs, timeout: float = 240) -> None:
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        errs.append(err.decode(errors="replace"))
    for p, err in zip(procs, errs):
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"


def _train(tmp_path, name: str, batch: int, echo: float = 0.0, prior_prob: float = 0.5):
    """A 2-rank job and one lone process at one seed, side by side; returns
    {"r0", "r1", "one"} -> (weights, log and flat-reduce count, prefix)."""
    port = _free_port()
    base = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    for var in tmesh.DIST_ENV_VARS + ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        base.pop(var, None)
    runs = {}
    procs = []
    for who, env in (("r0", dict(RANK="0")), ("r1", dict(RANK="1")), ("one", None)):
        if env is not None:
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2")
        prefix = str(tmp_path / f"{name}_{who}")
        runs[who] = prefix
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, prefix, str(batch), str(echo), str(prior_prob)],
            env=dict(base, **(env or {})), cwd=str(tmp_path), stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE))
    _wait(procs)
    out = {}
    for who, prefix in runs.items():
        weights = dict(np.load(prefix + ".npz"))
        with open(prefix + ".json") as f:
            out[who] = (weights, json.load(f), prefix)
    return out


def _max_diff(a: dict, b: dict) -> float:
    assert a.keys() == b.keys()
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


@pytest.mark.parametrize("echo,prior_prob", [(0.0, 0.5), (0.5, 1.0)],
                         ids=["mc_dropout", "echo_penalty"])
def test_two_gloo_ranks_train_what_one_process_trains(tmp_path, echo, prior_prob):
    runs = _train(tmp_path, "dp", 8, echo, prior_prob)
    (w0, info0, p0), (w1, info1, p1), (w, info, _) = runs["r0"], runs["r1"], runs["one"]
    assert all(w0[k].tobytes() == w1[k].tobytes() for k in w0)  # the ranks agree exactly
    assert _max_diff(w0, w) <= WEIGHTS_TOL
    assert info0["log"][0] == "data-parallel over 2 ranks (seq mesh)"
    steps = [m for m in info0["log"] if m.startswith("step")]
    assert steps == [m for m in info["log"] if m.startswith("step")]
    assert sum(" loss " in m for m in steps) == 3 and any("PROBE" in m for m in steps)
    if prior_prob == 1.0:
        assert all("prior=True" in m for m in steps if " loss " in m)
    assert info1["log"] == []  # rank 1 logs nothing
    assert info0["flat_reduces"] == info1["flat_reduces"] == 3  # one a step
    assert info["flat_reduces"] == 0
    # rank 0 alone writes the checkpoint and the probe's best
    assert os.path.exists(p0 + ".msgpack") and os.path.exists(p0 + ".msgpack.best")
    assert not os.path.exists(p1 + ".msgpack") and not os.path.exists(p1 + ".msgpack.best")


def test_a_batch_the_ranks_do_not_divide_trains_unsharded(tmp_path):
    runs = _train(tmp_path, "odd", 7)
    (w0, info0, p0), (w1, info1, p1), (w, info, _) = runs["r0"], runs["r1"], runs["one"]
    assert info0["log"][0] == ("batch 7 does not split over 2 ranks: training unsharded, the "
                               "whole batch on every rank")
    assert not any("data-parallel" in m for m in info0["log"])
    for got in (w0, w1):
        assert all(np.array_equal(got[k], w[k]) for k in w)  # each rank is the one process
    assert info0["flat_reduces"] == info1["flat_reduces"] == 0
    assert os.path.exists(p0 + ".msgpack") and not os.path.exists(p1 + ".msgpack")


def test_train_uahn_under_torch_distributed_run_is_data_parallel(tmp_path):
    """The verb with no new flag: two ranks at 224x320 on the procedural
    ground (no probe), one step; one data-parallel line, one weights file."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    for var in tmesh.DIST_ENV_VARS + ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(var, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "cuahn_vio_torch.cli", "train-uahn", "--device", "cpu", "--steps", "1",
         "--batch-size", "2", "--no-textures", "--no-effects", "--out", "w.msgpack"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines.count("data-parallel over 2 ranks (seq mesh)") == 1
    assert sum(m.startswith("step") for m in lines) == 1
    assert lines.count("wrote weights -> w.msgpack") == 1
    assert os.listdir(tmp_path) == ["w.msgpack"]


@pytest.fixture
def two_cards(monkeypatch):
    """``torch.cuda`` as on a host with 2 visible cards; records set_device."""
    bound = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", bound.append)
    for var in ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    return bound


def test_local_rank_picks_its_own_card(two_cards, monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert tmesh.bind_rank_device() == torch.device("cuda", 1)
    assert two_cards == [torch.device("cuda", 1)]


def test_a_coordinator_rank_takes_its_id_modulo_the_cards(two_cards):
    assert tmesh.bind_rank_device(3) == torch.device("cuda", 1)
    assert tmesh.bind_rank_device(4) == torch.device("cuda", 0)
    assert tmesh.bind_rank_device() is None  # nothing names a rank: a plain process
    assert two_cards == [torch.device("cuda", 1), torch.device("cuda", 0)]


@pytest.mark.parametrize("local_rank,local_world", [("2", "3"), ("0", "3"), ("2", None)])
def test_more_ranks_than_cards_is_refused(two_cards, monkeypatch, local_rank, local_world):
    monkeypatch.setenv("LOCAL_RANK", local_rank)
    if local_world is not None:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local_world)
    with pytest.raises(RuntimeError, match="3 ranks on this host but 2 visible CUDA devices"):
        tmesh.bind_rank_device()
    assert two_cards == []  # never falls back to sharing a card


def test_a_cuda_job_binds_before_it_joins(two_cards, monkeypatch):
    """``init_distributed`` on CUDA binds the rank's card before
    ``init_process_group`` (env rendezvous and coordinator alike); the
    CPU/gloo path binds nothing."""
    import torch.distributed as dist

    joined = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: joined.append((backend, list(two_cards))))
    for var in tmesh.DIST_ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    tmesh.init_distributed("127.0.0.1:1", 2, 1, device="cuda")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    tmesh.init_distributed(device="cuda")
    tmesh.init_distributed("127.0.0.1:1", 2, 1, device="cpu")
    assert joined == [("nccl", [torch.device("cuda", 1)]),
                      ("nccl", [torch.device("cuda", 1), torch.device("cuda", 0)]),
                      ("gloo", [torch.device("cuda", 1), torch.device("cuda", 0)])]
