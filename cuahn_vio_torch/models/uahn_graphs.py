"""CUDA graphs of the UAHN's no-grad call, one graph a stage.

A prior-mode call at ``close-loops``' 64 pairs launches ~320 kernels, most
of them small (the DLTs, the covariance transfer), and the host takes
longer to dispatch them than the card takes to run the call. So
``UAHN.forward`` replays a call whose key recurs from CUDA graphs:

- A call's key (``GraphCache.key``) holds all that decides what the call
  launches: each input's shape, dtype and device, the cascade
  (``use_prior``, ``blocks_to_run``), the dropout rate, the towers'
  compute dtype, the data pointers of the parameters and buffers, and the
  process settings that choose kernels (TF32, the float32 matmul
  precision, cuDNN's and torch's deterministic modes, cuDNN's benchmark
  mode, ``ops/warp.BATCH_SAMPLER``).
- A key's first call runs eagerly; it also fills cuDNN's, cuBLAS's and
  T1's caches. Its second call is captured (``StageGraphs``) and then
  replayed, and every later call is replayed. A shape that comes once
  (a run's last partial batch) never pays a capture.
- A replay copies the inputs into the graphs' static tensors, replays
  each stage's graph inside the stage's span (``utils/spans``), all
  inside ``vio.uahn.replay``, and returns clones of the static outputs:
  callers keep every call's outputs, and the next replay overwrites the
  static ones.
- A replay adds the launches its graphs captured to ``ops/cuda``'s
  counters, so they read as if the call had run eagerly.
- Parameters updated in place (an optimizer's step, ``load_state_dict``)
  keep their pointers, and a replay reads their current values; a
  parameter given new storage changes the key, so stale weights are
  never replayed.

Only calls on a CUDA device, outside another capture, are captured.
``GraphCache`` holds ``MAX_KEYS`` captured keys, dropping the least
recently used (and with it its memory pool).
"""

from __future__ import annotations

import itertools
from collections import OrderedDict
from typing import Callable, Optional

import torch

from cuahn_vio_torch.ops import cuda as cuda_ops
from cuahn_vio_torch.ops import warp
from cuahn_vio_torch.utils.spans import span

MAX_KEYS = 4  # captured keys held at once
MAX_SEEN = 64  # keys called once, remembered so that their next call captures


def _settings() -> tuple:
    """The process settings that choose the kernels a call launches."""
    return (torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision(),
            torch.are_deterministic_algorithms_enabled(), warp.BATCH_SAMPLER)


def _launches() -> list:
    return [dict(c) for c in cuda_ops.LAUNCH_COUNTERS]


class StageGraphs:
    """One call's stages captured as CUDA graphs in one private memory
    pool, with the static tensors they read and write.

    ``stages``: the call's (span, step) pairs (``UAHN.call_stages``);
    ``inputs``: its input tensors by name. The stages run once eagerly on
    a side stream (cuBLAS and cuSOLVER ready a stream's handle and
    workspace on its first use), then each is captured on that stream,
    its outputs the next ones' static inputs. A stage that returns no
    tensor (the masks at rate 0) launches nothing and gets no graph. The
    launch counters are left as they were before the capture."""

    def __init__(self, stages: list, inputs: dict):
        dev = inputs["img1"].device
        self.inputs = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                       for k, v in inputs.items()}
        for k, v in inputs.items():
            self.inputs[k].copy_(v)
        before = _launches()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.no_grad(), torch.cuda.device(dev), torch.cuda.stream(side):
                t, launches_nothing = dict(self.inputs), []
                for _, step in stages:
                    out = step(t)
                    t.update(out)
                    launches_nothing.append(all(v is None for v in out.values()))
                start = _launches()
                pool = torch.cuda.graph_pool_handle()
                t, self.graphs = dict(self.inputs), []
                for (name, step), nothing in zip(stages, launches_nothing):
                    graph = None if nothing else torch.cuda.CUDAGraph()
                    if graph is None:
                        t.update(step(t))
                    else:
                        with torch.cuda.graph(graph, pool=pool, stream=side,
                                              capture_error_mode="thread_local"):
                            t.update(step(t))
                    self.graphs.append((name, graph))
            torch.cuda.current_stream(dev).wait_stream(side)
            self.tensors = t  # every stage's outputs, held for the next stages' graphs
            self.launches = [{k: c[k] - s[k] for k in c} for c, s in zip(_launches(), start)]
        finally:
            for counter, was in zip(cuda_ops.LAUNCH_COUNTERS, before):
                counter.update(was)

    def replay(self, inputs: dict) -> tuple:
        """(flow8, cov88) of the call on ``inputs``, new tensors."""
        with span("vio.uahn.replay"):
            for k, v in inputs.items():
                self.inputs[k].copy_(v)
            for name, graph in self.graphs:
                with span(name):
                    if graph is not None:
                        graph.replay()
            for counter, added in zip(cuda_ops.LAUNCH_COUNTERS, self.launches):
                for k, n in added.items():
                    counter[k] += n
            return self.tensors["flow8"].clone(), self.tensors["cov88"].clone()


class GraphCache:
    """The captured calls of one model, by key. ``build(stages, inputs)``
    captures a call (``StageGraphs``); ``device_type`` is the device whose
    calls are captured."""

    def __init__(self, build: Callable = StageGraphs, device_type: str = "cuda"):
        self.build, self.device_type = build, device_type
        self._seen: OrderedDict = OrderedDict()
        self._graphs: OrderedDict = OrderedDict()

    def __reduce__(self):
        # a copy of the model (``copy.deepcopy``) has parameters of its own
        # and starts with no graphs
        return GraphCache, (self.build, self.device_type)

    def captured(self) -> list:
        """The captured keys, the least recently used first."""
        return list(self._graphs)

    def key(self, model, inputs: dict, use_prior: bool) -> Optional[tuple]:
        """The key of ``model``'s no-grad call on ``inputs`` (name ->
        tensor, ``UAHN._call_inputs``), or None where the call runs
        eagerly: an input missing (the eager call raises), another device,
        or a stream that is being captured already."""
        img1 = inputs["img1"]
        if any(v is None for v in inputs.values()) or img1.device.type != self.device_type:
            return None
        if img1.is_cuda and torch.cuda.is_current_stream_capturing():
            return None
        tensors = tuple((k, tuple(v.shape), v.dtype, v.device) for k, v in inputs.items())
        weights = tuple(p.data_ptr() for p in itertools.chain(model.parameters(), model.buffers()))
        return (tensors, use_prior, model.blocks_to_run, model.dropout_rate,
                model.block4.compute_dtype, weights, _settings())

    def lookup(self, key: tuple, stages: Callable[[], list], inputs: dict):
        """The captured call of ``key``, captured now (from ``stages()`` on
        ``inputs``) on the key's second call; None on its first."""
        graphs = self._graphs.get(key)
        if graphs is not None:
            self._graphs.move_to_end(key)
            return graphs
        if self._seen.pop(key, None) is None:
            self._seen[key] = True
            if len(self._seen) > MAX_SEEN:
                self._seen.popitem(last=False)
            return None
        if len(self._graphs) >= MAX_KEYS:
            self._graphs.popitem(last=False)
        graphs = self._graphs[key] = self.build(stages(), inputs)
        cuda_ops.uahn_calls["captured"] += 1
        return graphs
