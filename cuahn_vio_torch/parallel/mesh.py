"""The job's devices and collective metric sums over ``torch.distributed``.

Counterpart of ``cuahn_vio.parallel.mesh``. A ``Mesh`` is the ordered
devices of the job, one per process (rank): a single process has a mesh of
one device, a job of N processes one of N. A mesh device may hold several
sequences or blocks along a leading axis, so one card runs a batch of
sequences or a 4-block Schur solve by itself; the axis ``seq`` is split
into equal contiguous shards, one per rank (``shard_batch``).

Cross-rank traffic is ``torch.distributed.all_reduce`` (sum), over the
"gloo" backend for CPU tensors and "nccl" for CUDA ones, in place of the
JAX package's ``psum``. NCCL puts one rank on a GPU: a CUDA job binds each
process to its own card before it joins (``bind_rank_device``), so on a
machine with one card a job runs as one process (more ranks run on the
CPU with gloo).
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple, Optional

import torch

# Environment variables that say "this process is PART OF a distributed
# job": torch's own (env:// rendezvous) and the JAX package's list. If any
# is set, a failed initialization is fatal: carrying on as one process
# would give a silently wrong job.
DIST_ENV_VARS = (
    "MASTER_ADDR",
    "MASTER_PORT",
    "WORLD_SIZE",
    "RANK",
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
    "JAX_NUM_PROCESSES",
    "JAX_PROCESS_ID",
    "SLURM_JOB_NUM_NODES",
    "OMPI_COMM_WORLD_SIZE",
)
INIT_TIMEOUT_S = 120.0  # rendezvous and collectives: a lost peer fails, never hangs


def _backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def bind_rank_device(process_id: Optional[int] = None) -> Optional[torch.device]:
    """Bind this process to its own CUDA card (``torch.cuda.set_device``);
    call before the job is joined and before any tensor is made.

    The card is ``LOCAL_RANK`` where torch's launcher sets it (checked
    against ``LOCAL_WORLD_SIZE``, the ranks on this host), else the rank
    (``process_id``, or ``RANK``) modulo the visible cards: a
    ``--coordinator`` job is taken to be laid out host by host. Raises,
    naming the counts, when this host has more ranks than visible cards:
    NCCL puts one rank on a card, and ranks sharing ``cuda:0`` would be a
    wrong job, not a slow one. Returns the card; None when nothing names
    a rank (a plain process keeps the current device).
    """
    n_cards = torch.cuda.device_count()
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        local_rank = int(local)
        local_ranks = max(int(os.environ.get("LOCAL_WORLD_SIZE", "0")), local_rank + 1)
    else:
        if process_id is None and os.environ.get("RANK") is not None:
            process_id = int(os.environ["RANK"])
        if process_id is None:
            return None
        local_rank, local_ranks = process_id % max(n_cards, 1), 1
    if local_ranks > n_cards:
        raise RuntimeError(
            f"{local_ranks} ranks on this host but {n_cards} visible "
            "CUDA devices: NCCL needs a device of its own for each rank; start at most "
            f"{n_cards} ranks a host, or run on the CPU (gloo)")
    device = torch.device("cuda", local_rank)
    torch.cuda.set_device(device)
    return device


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device="cuda",
                     timeout_s: float = INIT_TIMEOUT_S) -> None:
    """Join a multi-process job (``torch.distributed.init_process_group``).

    With ``coordinator_address`` ("host:port", a TCP rendezvous that rank
    0 opens), ``num_processes`` and ``process_id``, joins that job. With
    no arguments, reads torch's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); a plain single process,
    none of ``DIST_ENV_VARS`` set, stays one process (a no-op). Where such
    variables are set and the rendezvous fails, it raises. The backend is
    "nccl" for a CUDA ``device``, "gloo" for the CPU; ``timeout_s`` bounds
    the rendezvous and every later collective. A CUDA job binds each
    process to its own card first (``bind_rank_device``), so a bare
    "cuda" is that card from then on.
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return
    timeout = datetime.timedelta(seconds=timeout_s)
    cuda = torch.device(device).type == "cuda"
    if coordinator_address is None and num_processes is None:
        env_hits = [v for v in DIST_ENV_VARS if os.environ.get(v)]
        if not env_hits:
            return
        if cuda:
            bind_rank_device()
        try:
            dist.init_process_group(_backend(device), init_method="env://", timeout=timeout)
        except Exception as e:
            raise RuntimeError(
                "torch.distributed initialization failed although distributed "
                f"environment variables are set ({', '.join(env_hits)}); "
                "refusing to run as a single process"
            ) from e
        return
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs num_processes and process_id")
    if cuda:
        bind_rank_device(int(process_id))
    dist.init_process_group(_backend(device), init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=timeout)


def world() -> tuple:
    """(world size, rank) of the job; (1, 0) outside a distributed job."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh(NamedTuple):
    """The job's devices in rank order; ``rank`` is this process's."""

    devices: tuple  # (world,) torch.device, devices[r] is rank r's
    rank: int = 0
    axis: str = "seq"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local(self) -> torch.device:
        """This process's device."""
        return self.devices[self.rank]


def make_mesh(device="cuda", n_devices: Optional[int] = None) -> Mesh:
    """The mesh of the job: one device per rank, each rank's own
    ``device`` (a bare "cuda" is the current CUDA device, the rank's card
    once ``init_distributed`` bound it), gathered from every rank.
    ``n_devices``, where given, must equal the job's size: a mesh device
    is a process here, and a process does not sit out."""
    from cuahn_vio_torch.pipeline.runner import resolve_device

    size, rank = world()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices in a job of {size} processes")
    local = resolve_device(device)
    if size == 1:
        return Mesh(devices=(local,), rank=rank)
    import torch.distributed as dist

    names = [None] * size
    dist.all_gather_object(names, str(local))
    return Mesh(devices=tuple(torch.device(n) for n in names), rank=rank)


def _map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        mapped = [_map(fn, x) for x in tree]
        return type(tree)(*mapped) if hasattr(tree, "_fields") else tuple(mapped)
    raise TypeError(f"cannot place a {type(tree).__name__}")


def shard_bounds(n: int, mesh: Mesh) -> tuple:
    """[start, stop) of this rank's contiguous shard of a leading axis n."""
    if n % mesh.size:
        raise ValueError(f"a leading axis of {n} does not split over {mesh.size} devices")
    per = n // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def shard_batch(tree, mesh: Mesh):
    """This rank's shard of a batch (a tensor or a (named) tuple of them;
    None stays None) along its leading ``seq`` axis, on the rank's device.
    Every tensor's leading axis must split evenly over the mesh."""
    def put(x):
        lo, hi = shard_bounds(x.shape[0], mesh)
        return x[lo:hi].to(mesh.local)

    return _map(put, tree)


def replicate(tree, mesh: Mesh):
    """The whole of a tree (params, configs) on this rank's device."""
    return _map(lambda x: x.to(mesh.local), tree)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the mesh's ranks (a copy; ``x`` itself where the
    mesh is one process)."""
    if mesh.size == 1:
        return x
    import torch.distributed as dist

    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


class _SumOverRanks(torch.autograd.Function):
    """A sum over the job's ranks whose backward sums the cotangents of the
    ranks' copies (the adjoint of a sum that every rank holds)."""

    @staticmethod
    def forward(ctx, x):
        import torch.distributed as dist

        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def differentiable_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the job's ranks, differentiable: the gradient of a
    quantity each rank computes from the sum reaches every rank's ``x``
    (count such a quantity 1 / world size in each rank's loss, since the
    ranks' copies are summed)."""
    return _SumOverRanks.apply(x)


def psum_metrics(tree, mesh: Mesh):
    """Collective metric sums: each tensor summed over its local leading
    axis (this rank's sequences or blocks), then over the ranks."""
    return _map(lambda x: all_reduce_sum(x.sum(dim=0), mesh), tree)


def all_gather_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' equal shards of a leading axis, concatenated in rank
    order (``x`` itself where the mesh is one process)."""
    if mesh.size == 1:
        return x
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)
