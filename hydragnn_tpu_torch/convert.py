"""Load the JAX package's flax variables and batches into the port.

The flax names map onto the port's modules as follows (``kernel [in, out]``
becomes ``Linear.weight [out, in]``):

====================================  =====================================
flax (``params`` / ``batch_stats``)   port module
====================================  =====================================
``graph_convs_{i}/eps``               ``graph_convs[i].eps``
``graph_convs_{i}/nn/dense_{j}``      ``graph_convs[i].nn.dense_{j}``
``feature_norm_{i}/{scale,bias}``     ``feature_layers[i].{scale,bias}``
``feature_norm_{i}/{mean,var}``       ``feature_layers[i].{mean,var}``
``graph_shared_{branch}/dense_{j}``   ``graph_shared[branch].dense_{j}``
``head{k}_{branch}/dense_{j}``        ``heads_NN[k][branch].dense_{j}``
====================================  =====================================

Inputs are nested dicts of numpy arrays (``jax.tree.map(np.asarray, ...)``
of the flax variables); this module imports no JAX.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .graphs.batching import batch_meta
from .graphs.graph import FIELDS, GraphBatch


def _flatten(tree, prefix=()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _port_name(path: tuple) -> str:
    """Flax variable path -> the port's ``state_dict`` key."""
    top, rest = path[0], list(path[1:])
    leaf = rest[-1]
    if leaf == "kernel":
        rest[-1] = "weight"
    m = re.fullmatch(r"graph_convs_(\d+)", top)
    if m:
        return ".".join([f"graph_convs.{m.group(1)}", *rest])
    m = re.fullmatch(r"feature_norm_(\d+)", top)
    if m:
        return ".".join([f"feature_layers.{m.group(1)}", *rest])
    m = re.fullmatch(r"graph_shared_(.+)", top)
    if m:
        return ".".join([f"graph_shared.{m.group(1)}", *rest])
    m = re.fullmatch(r"head(\d+)_(.+)", top)
    if m:
        return ".".join([f"heads_NN.{m.group(1)}.{m.group(2)}", *rest])
    raise KeyError(f"no port module for flax variable {'/'.join(path)}")


def load_jax_variables(model: torch.nn.Module, params: dict, batch_stats: dict | None = None):
    """Copy flax ``params`` (and ``batch_stats``) into ``model`` in place.
    Every port parameter and buffer must be covered, shapes must match."""
    flat = _flatten(params)
    flat.update(_flatten(batch_stats or {}))
    state = model.state_dict()
    seen = set()
    with torch.no_grad():
        for path, value in flat.items():
            key = _port_name(path)
            if key not in state:
                raise KeyError(f"flax variable {'/'.join(path)} -> {key}: not in the port model")
            if path[-1] == "kernel":
                value = value.T
            target = state[key]
            if tuple(target.shape) != tuple(value.shape):
                raise ValueError(
                    f"{'/'.join(path)} -> {key}: shape {value.shape} != {tuple(target.shape)}"
                )
            # np.array copies (writable, 0-d stays 0-d, unlike ascontiguousarray)
            target.copy_(torch.from_numpy(np.array(value)).to(target.dtype))
            seen.add(key)
    missing = set(state) - seen
    if missing:
        raise KeyError(f"port model entries without a flax variable: {sorted(missing)}")
    return model


def batch_from_numpy(nb) -> GraphBatch:
    """A port ``GraphBatch`` (CPU tensors) from a batch of numpy arrays with
    the ``GraphBatch`` fields (e.g. the JAX package's collate output), field
    by field; the sortedness certificates are computed from the arrays."""
    arrays = {f: np.ascontiguousarray(np.asarray(getattr(nb, f))) for f in FIELDS}
    jax_meta = getattr(nb, "meta", None)
    meta = batch_meta(arrays)
    node_cap = getattr(jax_meta, "max_n_node", None)
    if node_cap is not None:
        meta = type(meta)(max_n_node=int(node_cap), recv_sorted=meta.recv_sorted,
                          send_sorted=meta.send_sorted, batch_sorted=meta.batch_sorted)
    return GraphBatch(**{f: torch.from_numpy(a) for f, a in arrays.items()}, meta=meta)


__all__ = ["batch_from_numpy", "load_jax_variables"]
