"""UAHN weights: Flax msgpack checkpoints <-> a torch state dict.

The JAX package serializes its flax parameter tree with msgpack
(``cuahn_vio/utils/checkpoint.py``). ``load_params`` reads the same files
with the port's own decoder and renames/transposes each leaf for
``nn.Module``s:

- conv kernels HWIO -> OIHW;
- dense kernels (in, out) -> (out, in);
- ``kernel`` -> ``weight``; nesting joined with dots.

``save_params`` writes a state dict back in Flax's format (the inverse
mapping, ``params_to_numpy``; keys sorted at every level, as Flax writes
them), which the JAX package's ``load_params`` reads.

No fc reordering is needed: the JAX model flattens features in NCHW order
(``uahn.py:89-91``), the same order as ``torch.flatten`` on NCHW.

``save_filter_state`` / ``load_filter_state`` write and read a
``FilterState`` as the JAX package's functions do: an npz with one array a
field, under the field's name, the optional bias block's fields left out
when they are None.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cuahn_vio_torch.filter.state import FilterState

from cuahn_vio_torch.utils.msgpack_reader import unpackb
from cuahn_vio_torch.utils.msgpack_writer import packb


def _flatten(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, name + ".")
        else:
            yield name, np.asarray(v)


def kernel_to_port(kernel, name: str = "kernel"):
    """A Flax kernel (numpy array or tensor) in the port's layout: conv
    HWIO -> OIHW, dense (in, out) -> (out, in)."""
    if kernel.ndim == 4:
        return (kernel.permute(3, 2, 0, 1) if torch.is_tensor(kernel)
                else kernel.transpose(3, 2, 0, 1))
    if kernel.ndim == 2:
        return kernel.T
    raise ValueError(f"unexpected kernel rank {kernel.ndim} for {name}")


def flax_kernel_shape(weight_shape) -> tuple:
    """The Flax shape of a port weight's shape: OIHW -> HWIO, (out, in) ->
    (in, out)."""
    if len(weight_shape) == 4:
        o, i, kh, kw = weight_shape
        return (kh, kw, i, o)
    if len(weight_shape) == 2:
        return (weight_shape[1], weight_shape[0])
    raise ValueError(f"unexpected weight shape {tuple(weight_shape)}")


def params_from_numpy(tree: dict) -> dict[str, torch.Tensor]:
    """The JAX package's parameter tree (nested dicts of numpy arrays) ->
    the port's UAHN state dict (float32 CPU tensors)."""
    out = {}
    for name, arr in _flatten(tree):
        if name.endswith(".kernel"):
            name = name[: -len(".kernel")] + ".weight"
            arr = kernel_to_port(arr, name)
        out[name] = torch.tensor(np.asarray(arr, dtype=np.float32))
    return out


def load_params(path: str) -> dict[str, torch.Tensor]:
    """Flax msgpack checkpoint -> torch state dict for ``models.uahn.UAHN``."""
    with open(path, "rb") as f:
        return params_from_numpy(unpackb(f.read()))


def params_to_numpy(state_dict: dict) -> dict:
    """The inverse of ``params_from_numpy``: a UAHN state dict -> the JAX
    package's parameter tree (nested dicts, keys sorted, of float32 numpy
    arrays: conv kernels HWIO, dense kernels (in, out))."""
    tree: dict = {}
    for name, value in state_dict.items():
        arr = value.detach().to("cpu", torch.float32).numpy()
        if name.endswith(".weight"):
            name = name[: -len(".weight")] + ".kernel"
            if arr.ndim == 4:  # conv OIHW -> HWIO
                arr = arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:  # dense (out, in) -> (in, out)
                arr = arr.T
            else:
                raise ValueError(f"unexpected weight rank {arr.ndim} for {name}")
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(arr)

    def ordered(node):
        return {k: ordered(node[k]) if isinstance(node[k], dict) else node[k]
                for k in sorted(node)}

    return ordered(tree)


def save_params(path: str, state_dict: dict) -> None:
    """Write a UAHN state dict as a Flax msgpack checkpoint (written to a
    temporary file beside ``path``, then renamed over it)."""
    data = packb(params_to_numpy(state_dict))
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def save_filter_state(path: str, state: FilterState) -> None:
    """Write ``state`` as an npz of its fields (numpy, on the host); a None
    field (the bias block when it is off) is left out."""
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in state._asdict().items()
                      if v is not None})


def load_filter_state(path: str, device="cuda") -> FilterState:
    """The ``FilterState`` of an npz written by ``save_filter_state`` (or
    the JAX package's), its tensors on ``device``; absent fields are
    None."""
    with np.load(path) as d:
        return FilterState(**{k: torch.as_tensor(d[k], device=device) for k in d.files})
