"""Shared helpers of the ``test_torch_*`` files: the PyTorch port
(``hydragnn_tpu_torch``) held against the JAX package on the same inputs.

Data crosses between the two packages only as numpy arrays. Importing this
module pins torch to one CPU thread, so the port's CPU sums run in one
deterministic order and the parallel test workers do not oversubscribe the
machine.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

torch.set_num_threads(1)

_SAMPLE_FIELDS = (
    "x", "pos", "senders", "receivers", "edge_attr", "edge_shifts", "graph_attr",
    "graph_y", "node_y", "energy_y", "forces_y", "dataset_id", "cell", "pbc",
)


def port_samples(jax_samples):
    """Deep copies of JAX ``GraphSample``s as the port's ``GraphSample``s."""
    from hydragnn_tpu_torch.graphs.graph import GraphSample

    out = []
    for s in jax_samples:
        kw = {f: copy.deepcopy(getattr(s, f)) for f in _SAMPLE_FIELDS}
        out.append(GraphSample(**kw, extras=copy.deepcopy(s.extras)))
    return out


def jax_samples_copy(jax_samples):
    return [copy.deepcopy(s) for s in jax_samples]


def numpy_tree(tree):
    """A flax variable tree as nested dicts of numpy arrays."""
    return {k: numpy_tree(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


def port_model_from_jax(jax_cfg_aug, variables):
    """The port's model for an augmented config, holding the JAX model's
    ``params`` and ``batch_stats`` (CPU)."""
    from hydragnn_tpu_torch.convert import load_jax_variables
    from hydragnn_tpu_torch.models import create_model_config

    model = create_model_config(copy.deepcopy(jax_cfg_aug), device="cpu")
    return load_jax_variables(model, numpy_tree(variables["params"]),
                              numpy_tree(variables.get("batch_stats", {})))


def random_batch_stats(variables, seed: int = 0):
    """``variables`` with non-trivial batch-norm running statistics (mean
    around 0, var in [0.5, 2]), so eval-mode normalisation is exercised."""
    import jax

    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = np.shape(leaf)
        if name == "mean":
            return np.asarray(rng.normal(scale=0.1, size=shape), np.float32)
        return np.asarray(rng.uniform(0.5, 2.0, size=shape), np.float32)

    stats = jax.tree_util.tree_map_with_path(draw, variables["batch_stats"])
    return {**variables, "batch_stats": stats}


def jitter_params(variables, seed: int = 0, scale: float = 0.05):
    """``variables`` with every parameter moved by a small seeded amount
    (GIN ``eps``, biases and BN scale/bias leave their zero/one init)."""
    import jax

    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda p: np.asarray(p + rng.normal(scale=scale, size=np.shape(p)), np.float32),
        variables["params"],
    )
    return {**variables, "params": params}


def assert_within_jax_bf16_gap(got, want, want_fp32, rtol: float, atol: float, what: str = ""):
    """Per entry, ``|got - want| <= atol + rtol |want| + |want - want_fp32|``:
    a bf16 result of the port against the JAX package's bf16 result, at a
    bound widened by the JAX package's own bf16 distance from its fp32
    result on that entry (never by the port's own). Returns the largest
    share of the bound used."""
    got, want, want_fp32 = (np.asarray(a, np.float64) for a in (got, want, want_fp32))
    bound = atol + rtol * np.abs(want) + np.abs(want - want_fp32)
    excess = np.abs(got - want) - bound
    assert (excess <= 0).all(), f"{what}: max |port - JAX| beyond its bound by {excess.max():.3e}"
    return float((np.abs(got - want) / bound).max())


__all__ = [
    "assert_within_jax_bf16_gap",
    "jax_samples_copy",
    "jitter_params",
    "numpy_tree",
    "port_model_from_jax",
    "port_samples",
    "random_batch_stats",
]
