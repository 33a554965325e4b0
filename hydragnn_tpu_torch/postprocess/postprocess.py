"""Output denormalisation: min-max-normalised predictions and targets back
to physical units, from the min-max tables the data pipeline recorded.
Counterpart of ``hydragnn_tpu/postprocess/postprocess.py``."""

from __future__ import annotations

import numpy as np


def head_scales(voi: dict, spec) -> list:
    """Per-head ``(lo, rng)`` scales. Node min-max columns are [input
    features..., node targets...]: targets start after the inputs."""
    node_minmax = np.asarray(voi.get("minmax_node_feature", []))
    graph_minmax = np.asarray(voi.get("minmax_graph_feature", []))
    node_target_dims = sum(d for d, t in zip(spec.output_dim, spec.output_type) if t == "node")
    x_dim = node_minmax.shape[1] - node_target_dims if node_minmax.size else 0
    scales = []
    g_off = n_off = 0
    for otype, dim in zip(spec.output_type, spec.output_dim):
        if otype == "graph" and graph_minmax.size:
            lo = graph_minmax[0, g_off : g_off + dim]
            hi = graph_minmax[1, g_off : g_off + dim]
            g_off += dim
        elif otype == "node" and node_minmax.size:
            lo = node_minmax[0, x_dim + n_off : x_dim + n_off + dim]
            hi = node_minmax[1, x_dim + n_off : x_dim + n_off + dim]
            n_off += dim
        else:
            lo, hi = 0.0, 1.0
        span = np.asarray(hi) - np.asarray(lo)
        scales.append((lo, np.where(span < 1e-12, 1.0, span)))
    return scales


def output_denormalize(voi: dict, true_values, predicted_values, spec):
    """``y = y_norm * (max - min) + min`` per head."""
    out_t, out_p = [], []
    for ihead, (lo, rng) in enumerate(head_scales(voi, spec)):
        out_t.append(true_values[ihead] * rng + lo)
        out_p.append(predicted_values[ihead] * rng + lo)
    return out_t, out_p


def unscale_features_by_num_nodes(datasets_list, scaled_index_list, nodes_num_list):
    """Undo per-num-nodes scaling of extensive targets (reference
    ``postprocess.py:29-39``): multiply each sample's values for the listed
    heads by that sample's node count. ``datasets_list`` is e.g.
    ``[true_values, predicted_values]`` with layout [head][sample][...]."""
    counts = [float(n) for n in nodes_num_list]
    for dataset in datasets_list:
        for idx in scaled_index_list:
            dataset[idx] = [np.asarray(sample) * counts[i]
                            for i, sample in enumerate(dataset[idx])]
    return datasets_list


def unscale_features_by_num_nodes_config(config, datasets_list, nodes_num_list):
    """Config-driven variant (reference ``postprocess.py:42-54``): heads whose
    output name carries ``_scaled_num_nodes`` are unscaled; requires
    ``denormalize_output``, so that values are in physical units first."""
    var_config = config["NeuralNetwork"]["Variables_of_interest"]
    output_names = var_config.get("output_names", [])
    scaled = [i for i, n in enumerate(output_names) if "_scaled_num_nodes" in n]
    if scaled:
        assert var_config.get("denormalize_output"), \
            "Cannot unscale features without 'denormalize_output'"
        datasets_list = unscale_features_by_num_nodes(datasets_list, scaled, nodes_num_list)
    return datasets_list


__all__ = ["head_scales", "output_denormalize", "unscale_features_by_num_nodes",
           "unscale_features_by_num_nodes_config"]
