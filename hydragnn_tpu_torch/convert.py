"""Load the JAX package's flax variables and batches into the port.

The flax names map onto the port's modules as follows (``kernel [in, out]``
becomes ``Linear.weight [out, in]``):

========================================  ======================================================
flax (``params`` / ``batch_stats``)       port module
========================================  ======================================================
``graph_convs_{i}/eps``                   ``graph_convs[i].eps`` (GIN)
``graph_convs_{i}/nn/dense_{j}``          ``graph_convs[i].nn.dense_{j}`` (GIN)
``graph_convs_{i}/{lin_l,lin_r,att}``     ``graph_convs[i].{lin_l,lin_r,att}`` (GAT)
``graph_convs_{i}/lin_edge``              ``graph_convs[i].lin_edge`` (GAT, edge features)
``graph_convs_{i}/local/...``             ``graph_convs[i].local...`` (GPS)
``graph_convs_{i}/attn/{q,k,v,out}``      ``graph_convs[i].attn.{q,k,v,out}`` (GPS, both attentions)
(``projections``, see below)              ``graph_convs[i].attn.w`` (GPS performer)
``graph_convs_{i}/rel_pos_emb``           ``graph_convs[i].rel_pos_emb`` (GPS, edge convs)
``graph_convs_{i}/{edge_emb,edge_lin}``   ``graph_convs[i].{edge_emb,edge_lin}`` (GPS, edge features)
``graph_convs_{i}/norm{1,2,3}``           ``graph_convs[i].norm{1,2,3}`` (GPS)
``graph_convs_{i}/mlp_{0,1}``             ``graph_convs[i].mlp_{0,1}`` (GPS)
``graph_convs_{i}/local_proj``            ``graph_convs[i].local_proj`` (GPS)
``graph_convs_{i}/edge_mlp/...``          ``graph_convs[i].edge_mlp...`` (EGNN)
``graph_convs_{i}/coord_mlp_mlp_0``       ``graph_convs[i].coord_mlp_mlp_0`` (EGNN)
``graph_convs_{i}/coord_mlp_mlp_out``     ``graph_convs[i].coord_mlp_mlp_out`` (EGNN)
``graph_convs_{i}/node_mlp/...``          ``graph_convs[i].node_mlp...`` (EGNN)
``graph_convs_{i}/{lin_root,lin_nbr}``    ``graph_convs[i].{lin_root,lin_nbr}`` (SAGE)
``graph_convs_{i}/{w_root,w_nbr,bias}``   ``graph_convs[i].{w_root,w_nbr,bias}`` (MFC)
``graph_convs_{i}/{filter1,filter2}``     ``graph_convs[i].{filter1,filter2}`` (SchNet)
``graph_convs_{i}/{lin1,lin2}``           ``graph_convs[i].{lin1,lin2}`` (SchNet)
``graph_convs_{i}/coord_mlp_{0,out}``     ``graph_convs[i].coord_mlp_{0,out}`` (SchNet)
``graph_convs_{i}/{pre_nn,post_nn,lin}``  ``graph_convs[i].{pre_nn,post_nn,lin}`` (PNA, PNAPlus)
``graph_convs_{i}/rbf/freq``              ``graph_convs[i].rbf.freq`` (PNAPlus)
``graph_convs_{i}/{rbf_emb,rbf_lin}``     ``graph_convs[i].{rbf_emb,rbf_lin}`` (PNAPlus)
``graph_convs_{i}/{lin_f,lin_s,proj}``    ``graph_convs[i].{lin_f,lin_s,proj}`` (CGCNN)
``graph_convs_{i}/edge_encoder``          ``graph_convs[i].edge_encoder`` (PNAPlus, PNAEq)
``graph_convs_{i}/message/edge_filter_*`` ``graph_convs[i].message.edge_filter_*`` (PAINN)
``{pos_emb,node_emb,node_lin}``           ``{pos_emb,node_emb,node_lin}`` (GPS)
``feature_norm_{i}/{scale,bias}``         ``feature_layers[i].{scale,bias}`` (not EGNN, SchNet)
``feature_norm_{i}/{mean,var}``           ``feature_layers[i].{mean,var}``
``graph_shared_{branch}/dense_{j}``       ``graph_shared[branch].dense_{j}``
``head{k}_{branch}/dense_{j}``            ``heads_NN[k][branch].dense_{j}`` (every branch)
``head{k}_{branch}/{w_i,b_i}``            ``heads_NN[k][branch].{w_i,b_i}`` (``mlp_per_node``)
``head{k}_{branch}_conv{j}/...``          ``heads_NN[k][branch].conv{j}...`` (``conv`` head)
``head{k}_{branch}_convout/...``          ``heads_NN[k][branch].convout...`` (``conv`` head)
``graph_conditioner/dense_{j}``           ``graph_conditioner.dense_{j}`` (``film``)
``graph_concat_projector``                ``graph_concat_projector`` (``concat_node``)
``graph_pool_projector/dense_{j}``        ``graph_pool_projector.dense_{j}`` (``fuse_pool``)
========================================  ======================================================

The other stacks' parameters map the same way, name for name. Inputs are
nested dicts of numpy arrays (``jax.tree.map(np.asarray, ...)`` of the
flax variables, or of the matching optax moments); this module imports no
JAX. The GPS performer's fixed projection is no flax variable (the JAX
package draws it in the forward from a key hashed from the module path):
it is passed as ``projections``, keyed by that module path
(``graph_convs_{i}/attn``).
"""

from __future__ import annotations

import dataclasses
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
    if top in ("pos_emb", "node_emb", "node_lin", "graph_conditioner",
               "graph_concat_projector", "graph_pool_projector"):
        return ".".join([top, *rest])
    m = re.fullmatch(r"graph_convs_(\d+)", top)
    if m:
        return ".".join([f"graph_convs.{m.group(1)}", *rest])
    m = re.fullmatch(r"feature_norm_(\d+)", top)
    if m:
        return ".".join([f"feature_layers.{m.group(1)}", *rest])
    m = re.fullmatch(r"graph_shared_(.+)", top)
    if m:
        return ".".join([f"graph_shared.{m.group(1)}", *rest])
    # a conv head's layers are head{k}_{branch}_conv{j} / _convout; branch
    # names ("branch-{n}") hold no underscore
    m = re.fullmatch(r"head(\d+)_([^_]+)(?:_(conv\d+|convout))?", top)
    if m:
        return ".".join([f"heads_NN.{m.group(1)}.{m.group(2)}",
                         *([m.group(3)] if m.group(3) else []), *rest])
    raise KeyError(f"no port module for flax variable {'/'.join(path)}")


def port_module_name(jax_path: str) -> str:
    """A flax module path as the JAX package's quantized serving keys its
    tables (``graph_convs_0/nn/dense_0``) -> the port's module name
    (``graph_convs.0.nn.dense_0``)."""
    return _port_name(tuple(jax_path.split("/")) + ("bias",)).removesuffix(".bias")


def port_arrays(tree: dict) -> dict[str, np.ndarray]:
    """A flax-shaped tree (variables, their gradients or optimizer moments)
    as ``{port state_dict key: array}``, kernels transposed to ``[out, in]``.
    ``np.array`` copies: writable, and a 0-d leaf stays 0-d (unlike
    ``np.ascontiguousarray``)."""
    return {
        _port_name(path): np.array(value.T if path[-1] == "kernel" else value)
        for path, value in _flatten(tree).items()
    }


def _copy_into(targets: dict[str, torch.Tensor], arrays: dict[str, np.ndarray],
               what: str) -> None:
    """Copy every array into the tensor of the same key; every target must
    be covered and shapes must match."""
    with torch.no_grad():
        for key, value in arrays.items():
            if key not in targets:
                raise KeyError(f"{what} {key}: not in the port model")
            target = targets[key]
            if tuple(target.shape) != tuple(value.shape):
                raise ValueError(f"{what} {key}: shape {value.shape} != {tuple(target.shape)}")
            target.copy_(torch.from_numpy(value).to(target.dtype))
    missing = set(targets) - set(arrays)
    if missing:
        raise KeyError(f"port model entries without a flax variable: {sorted(missing)}")


def load_jax_variables(model: torch.nn.Module, params: dict, batch_stats: dict | None = None,
                       projections: dict | None = None):
    """Copy flax ``params`` (and ``batch_stats``, and the GPS performer's
    ``projections``: ``{"graph_convs_{i}/attn": w [heads, Dh, m]}``) into
    ``model`` in place. Every port parameter and buffer must be covered,
    shapes must match."""
    arrays = port_arrays(params)
    arrays.update(port_arrays(batch_stats or {}))
    for path, w in (projections or {}).items():
        arrays[_port_name(tuple(path.split("/")) + ("w",))] = np.array(w, np.float32)
    _copy_into(model.state_dict(), arrays, "flax variable")
    return model


def load_optax_adam_state(optimizer: torch.optim.Optimizer, model: torch.nn.Module,
                          mu: dict, nu: dict, count: int, learning_rate: float):
    """Carry an optax Adam/AdamW state across: the first and second moments
    ``mu``/``nu`` (flax-param-shaped trees), the step ``count`` (optax's
    bias-correction step) and the injected learning rate, into the
    ``torch.optim`` Adam/AdamW ``optimizer`` over ``model``'s parameters."""
    params = dict(model.named_parameters())
    for name, arrays in (("exp_avg", port_arrays(mu)), ("exp_avg_sq", port_arrays(nu))):
        targets = {}
        for key, p in params.items():
            state = optimizer.state[p]
            state.setdefault(name, torch.zeros_like(p, memory_format=torch.preserve_format))
            targets[key] = state[name]
        _copy_into(targets, arrays, f"optax {name}")
    for p in params.values():
        optimizer.state[p]["step"] = torch.tensor(float(count), dtype=torch.float32)
    for group in optimizer.param_groups:
        group["lr"] = float(learning_rate)
    return optimizer


def _member(tree, i: int):
    """Member ``i``'s slice of a tree of ``[N, ...]`` arrays."""
    if isinstance(tree, dict):
        return {k: _member(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def load_jax_population(pstate, params: dict, batch_stats: dict | None = None,
                        projections: dict | None = None):
    """Copy a JAX ``PopulationState``'s stacked flax variables (the numpy
    arrays of ``pstate.state.params`` and ``batch_stats``, every leaf ``[N,
    ...]``; the GPS performer's ``projections`` shared) into the port's
    population (``train/population.py``) in place, member by member: each
    member's slice is carried as :func:`load_jax_variables` carries one
    model's. Every stacked parameter and buffer must be covered."""
    targets = pstate.model.state_dict()
    n = pstate.n_members
    for i in range(n):
        arrays = port_arrays(_member(params, i))
        arrays.update(port_arrays(_member(batch_stats or {}, i)))
        for path, w in (projections or {}).items():
            arrays[_port_name(tuple(path.split("/")) + ("w",))] = np.array(w, np.float32)
        _copy_into({k: t[i] for k, t in targets.items()}, arrays, f"member {i} flax variable")
    return pstate


def batch_from_numpy(nb) -> GraphBatch:
    """A port ``GraphBatch`` (CPU tensors) from a batch of numpy arrays with
    the ``GraphBatch`` fields (e.g. the JAX package's collate output), field
    by field; the sortedness certificates are computed from the arrays."""
    arrays = {f: np.ascontiguousarray(np.asarray(getattr(nb, f))) for f in FIELDS}
    jax_meta = getattr(nb, "meta", None)
    meta = batch_meta(arrays)
    node_cap = getattr(jax_meta, "max_n_node", None)
    if node_cap is not None:
        meta = dataclasses.replace(meta, max_n_node=int(node_cap))
    return GraphBatch(**{f: torch.from_numpy(a) for f, a in arrays.items()}, meta=meta)


__all__ = ["batch_from_numpy", "load_jax_population", "load_jax_variables",
           "load_optax_adam_state", "port_arrays", "port_module_name"]
