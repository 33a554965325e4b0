"""Config system: the reference JSON schema, validated and augmented.

Counterpart of ``hydragnn_tpu/config/schema.py`` as far as the ported
paths need it: ``load_config``, ``update_config`` (default filling,
multibranch head normalisation, output dims/types from the ``Dataset``
feature dims, input dim, the GPS defaults and GPS's dense-attention width
``max_graph_nodes``) and the typed ``ModelSpec`` view the model factory
reads, with the interatomic-potential (MLIP) keys and the ``MD`` block
(validated against ``md.MDConfig``), and the derivations of the invariant
stacks: PNA's in-degree histogram (``pna_deg``, and ``max_neighbours`` from
its length; PNAEq's too), CGCNN's hidden width (its input width without
GPS), MACE's mean neighbour count (``avg_num_neighbors``) and the
edge-dimension rules; the graph size (``num_nodes``, ``graph_size_variable``:
``mlp_per_node`` heads need one size) and the width of the graph
attributes (``graph_attr_dim``, port-only: the port builds its conditioning
layers when the model is constructed, flax at its first call). The blocks
of subsystems the port does not have yet come with their slices.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from copy import deepcopy

import numpy as np

CONFIG_SECTIONS = frozenset(
    {"Verbosity", "Dataset", "NeuralNetwork", "Visualization", "Serving",
     "MD", "Telemetry", "Screening"}
)

# architectures grouped by capability, as the JAX package groups them
PNA_MODELS = ("PNA", "PNAPlus", "PNAEq")
EDGE_MODELS = (
    "GAT", "PNA", "PNAPlus", "PAINN", "PNAEq", "CGCNN", "SchNet", "EGNN",
    "DimeNet", "MACE",
)

def load_config(source: str | dict) -> dict:
    """A JSON file path or an already-parsed dict (copied)."""
    if isinstance(source, dict):
        return deepcopy(source)
    with open(source) as f:
        return json.load(f)


def update_multibranch_heads(output_heads: dict) -> dict:
    """Legacy single-branch head configs become the multibranch form: each
    head family is a list of ``{"type": "branch-N", "architecture": {...}}``."""
    updated = dict(output_heads)
    for name, val in output_heads.items():
        if isinstance(val, list):
            for branch in val:
                if not (isinstance(branch, dict) and "type" in branch and "architecture" in branch):
                    raise ValueError(
                        f"output_heads['{name}'] does not contain proper branch config: {val}"
                    )
        elif isinstance(val, dict):
            updated[name] = [{"type": "branch-0", "architecture": val}]
        else:
            raise ValueError("Unknown output_heads config!")
    return updated


def _degree_histogram(samples) -> list[int]:
    """In-degree histogram over the training samples: entry ``d`` counts
    the nodes with ``d`` incoming edges (PNA's ``deg``)."""
    per_sample = []
    for s in samples:
        deg = np.bincount(np.asarray(s.receivers), minlength=s.num_nodes)[: s.num_nodes]
        per_sample.append(np.bincount(deg))
    if not per_sample:
        return [0]
    width = max(h.shape[0] for h in per_sample)
    hist = np.zeros(width, np.int64)
    for h in per_sample:
        hist[: h.shape[0]] += h
    return hist.tolist()


def _avg_num_neighbors(samples) -> float:
    """Edges per node over the training samples (MACE's message
    normaliser)."""
    tot_edges = sum(s.num_edges for s in samples)
    tot_nodes = sum(s.num_nodes for s in samples)
    return float(tot_edges) / max(tot_nodes, 1)


def update_config(config: dict, train_samples, val_samples=None, test_samples=None) -> dict:
    """Fill defaults and derive the data-dependent architecture fields from
    the training samples (``GraphSample``s). Returns a new dict."""
    config = deepcopy(config)
    nn = config.setdefault("NeuralNetwork", {})
    arch = nn.setdefault("Architecture", {})
    voi = nn.setdefault("Variables_of_interest", {})
    training = nn.setdefault("Training", {})

    serving_cfg = config.setdefault("Serving", {})
    if not isinstance(serving_cfg, dict):
        raise ValueError(f"Serving must be a dict, got {type(serving_cfg).__name__}")
    from ..serve.fleet.config import fleet_config_defaults
    from ..serve.server import ServingConfig, serving_config_defaults

    ServingConfig.from_config(config)  # unknown keys
    # the nested Serving.fleet block: a partial block (and a partial
    # autoscale or rollout sub-block) keeps the caller's keys and gains the
    # rest; unknown keys survive the fill and raise in validate()
    fleet_cfg = serving_cfg.setdefault("fleet", {})
    if not isinstance(fleet_cfg, dict):
        raise ValueError(f"Serving.fleet must be a dict, got {type(fleet_cfg).__name__}")
    for key, val in fleet_config_defaults().items():
        filled = fleet_cfg.setdefault(key, val)
        if isinstance(val, dict) and isinstance(filled, dict) and filled is not val:
            for sub_key, sub_val in val.items():
                filled.setdefault(sub_key, sub_val)
    for key, val in serving_config_defaults().items():
        serving_cfg.setdefault(key, val)
    ServingConfig(**serving_cfg).validate()

    # on-device MD (md.py): the MD block's defaults are the MDConfig field
    # defaults, and MDConfig validates it
    md_cfg = config.setdefault("MD", {})
    if not isinstance(md_cfg, dict):
        raise ValueError(f"MD must be a dict, got {type(md_cfg).__name__}")
    from ..md import MDConfig, md_config_defaults

    MDConfig.from_config(config)  # unknown keys and ranges
    for key, val in md_config_defaults().items():
        md_cfg.setdefault(key, val)

    arch.setdefault("enable_interatomic_potential", False)

    # GPS defaults; the dense-attention width (8-aligned) is derived from
    # the largest training graph unless the user set it
    arch.setdefault("global_attn_engine", None)
    arch.setdefault("global_attn_type", None)
    arch.setdefault("global_attn_heads", 0)
    arch.setdefault("pe_dim", 0)
    if arch.get("global_attn_engine") and not arch.get("max_graph_nodes"):
        max_n = max((s.num_nodes for s in train_samples), default=0)
        arch["max_graph_nodes"] = int(math.ceil(max(max_n, 1) / 8) * 8)
    else:
        arch.setdefault("max_graph_nodes", None)

    arch["output_heads"] = update_multibranch_heads(arch.get("output_heads", {}))

    output_type = list(voi.get("type", []))
    output_index = list(voi.get("output_index", []))
    if "output_dim" in voi and voi["output_dim"]:
        dims_list = list(voi["output_dim"])
    else:
        dims_list = []
        for ihead, otype in enumerate(output_type):
            feats = (
                config["Dataset"]["graph_features"]
                if otype == "graph"
                else config["Dataset"]["node_features"]
            )
            dims_list.append(int(feats["dim"][output_index[ihead]]))
    arch["output_dim"] = dims_list
    arch["output_type"] = output_type
    # the graph size, from the training samples (the JAX package's
    # HYDRAGNN_USE_VARIABLE_GRAPH_SIZE override is not ported): a per-node
    # head keeps one weight bank per node position
    first = train_samples[0] if len(train_samples) else None
    arch["num_nodes"] = int(first.num_nodes) if first is not None else None
    arch["graph_size_variable"] = len({s.num_nodes for s in train_samples}) > 1
    if arch["graph_size_variable"]:
        for branch in arch["output_heads"].get("node", []):
            if branch["architecture"].get("type") == "mlp_per_node":
                raise ValueError(
                    '"mlp_per_node" is not allowed for variable graph size; use "mlp" or "conv"'
                )
    if first is not None:
        arch["graph_attr_dim"] = int(first.graph_attr.shape[0])
    else:
        arch.setdefault("graph_attr_dim", 0)
    arch["input_dim"] = len(voi.get("input_node_features", []))

    # PNA's degree histogram, and the neighbour bound it implies
    if arch.get("mpnn_type") in PNA_MODELS:
        if arch.get("pna_deg") is None:
            arch["pna_deg"] = _degree_histogram(train_samples)
        arch["max_neighbours"] = len(arch["pna_deg"]) - 1
    else:
        arch.setdefault("pna_deg", None)
    # CGCNN's update is residual: without GPS its width is its input's
    if arch.get("mpnn_type") == "CGCNN" and not arch.get("global_attn_engine"):
        arch["hidden_dim"] = arch["input_dim"]
    # MACE divides its aggregated messages by the mean neighbour count
    if arch.get("mpnn_type") == "MACE":
        if arch.get("avg_num_neighbors") is None:
            arch["avg_num_neighbors"] = _avg_num_neighbors(train_samples)
    else:
        arch.setdefault("avg_num_neighbors", None)

    # edge dimension: the edge features' count, for the stacks that read
    # them; CGCNN's is 0 without them
    arch["edge_dim"] = None
    if arch.get("edge_features"):
        if arch["mpnn_type"] not in EDGE_MODELS:
            raise ValueError(f"Edge features can only be used with {', '.join(EDGE_MODELS)}.")
        if arch.get("enable_interatomic_potential"):
            raise ValueError("Edge features cannot be used with interatomic potentials.")
        arch["edge_dim"] = len(arch["edge_features"])
    elif arch.get("mpnn_type") == "CGCNN":
        arch["edge_dim"] = 0

    arch.setdefault("activation_function", "relu")
    training.setdefault("loss_function_type", "mse")
    training.setdefault("precision", "fp32")
    from ..train.step import KNOWN_PRECISIONS

    if str(training["precision"]) not in KNOWN_PRECISIONS:
        raise ValueError(
            f"Training.precision {training['precision']!r} not one of "
            f"{sorted(KNOWN_PRECISIONS)}"
        )
    training.setdefault("batch_size", 32)
    training.setdefault("conv_checkpointing", False)
    training.setdefault("Optimizer", {"type": "AdamW", "learning_rate": 1e-3})
    voi.setdefault("denormalize_output", False)
    return config


@dataclasses.dataclass(frozen=True)
class HeadBranchSpec:
    branch: str  # "branch-0", "branch-1", ...
    num_sharedlayers: int = 0
    dim_sharedlayers: int = 0
    num_headlayers: int = 1
    dim_headlayers: tuple[int, ...] = ()
    node_type: str | None = None  # "mlp" | "mlp_per_node" | "conv" for node heads


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Everything the model factory needs, read from the augmented dict."""

    mpnn_type: str
    input_dim: int
    hidden_dim: int
    num_conv_layers: int
    output_dim: tuple[int, ...]
    output_type: tuple[str, ...]  # "graph" | "node" per head
    graph_heads: tuple[HeadBranchSpec, ...]
    node_heads: tuple[HeadBranchSpec, ...]
    task_weights: tuple[float, ...]
    activation: str = "relu"
    graph_pooling: str = "mean"
    loss_type: str = "mse"
    freeze_conv_layers: bool = False
    initial_bias: float | None = None
    dropout: float = 0.25  # GAT's attention and GPS's dropout (train mode only)
    global_attn_engine: str | None = None  # "GPS" or None
    global_attn_type: str | None = None  # GPS: "multihead" (None) or a later slice's
    global_attn_heads: int = 0
    max_graph_nodes: int | None = None  # GPS dense-attention width
    pe_dim: int = 0  # Laplacian positional encodings per node (GPS)
    equivariance: bool | None = None  # EGNN and SchNet coordinate updates
    # geometry and radial bases (SchNet, PNAPlus and the geometric stacks),
    # degree banks (MFC, PNA, PNAEq)
    radius: float | None = None
    max_neighbours: int | None = None
    pna_deg: tuple[int, ...] | None = None
    radial_type: str | None = None
    num_gaussians: int | None = None
    num_filters: int | None = None
    num_radial: int | None = None
    envelope_exponent: int | None = None
    # DimeNet's spherical basis and interaction block
    num_spherical: int | None = None
    basis_emb_size: int | None = None
    int_emb_size: int | None = None
    out_emb_size: int | None = None
    num_before_skip: int | None = None
    num_after_skip: int | None = None
    # MACE's irreps orders, correlation order and message normaliser
    max_ell: int | None = None
    node_max_ell: int | None = None
    correlation: object = None
    avg_num_neighbors: float | None = None
    # interatomic potentials: energy head, forces from the position gradient
    enable_interatomic_potential: bool = False
    energy_weight: float = 0.0
    energy_peratom_weight: float = 0.0
    force_weight: float = 0.0
    edge_dim: int = 0
    # graph-attribute conditioning: "film", "concat_node" or "fuse_pool";
    # graph_attr_dim (port-only) is the attributes' width, 0 for none (then
    # no conditioning layer exists, as flax creates none it never calls)
    use_graph_attr_conditioning: bool = False
    graph_attr_conditioning_mode: str = "concat_node"
    graph_attr_dim: int = 0
    # GaussianNLLLoss: every head predicts a mean and a variance
    var_output: bool = False
    # one graph size (mlp_per_node heads), from the training samples
    num_nodes: int | None = None
    graph_size_variable: bool = False
    # recompute each conv layer's activations in the backward
    conv_checkpointing: bool = False

    @property
    def num_heads(self) -> int:
        return len(self.output_dim)

    @staticmethod
    def from_config(config: dict) -> "ModelSpec":
        arch = config["NeuralNetwork"]["Architecture"]
        training = config["NeuralNetwork"].get("Training", {})
        heads_cfg = arch.get("output_heads", {})

        def branches(family: str) -> tuple[HeadBranchSpec, ...]:
            out = []
            for b in heads_cfg.get(family, []):
                a = b["architecture"]
                dims = a.get("dim_headlayers", [])
                out.append(
                    HeadBranchSpec(
                        branch=b["type"],
                        num_sharedlayers=int(a.get("num_sharedlayers", 0)),
                        dim_sharedlayers=int(a.get("dim_sharedlayers", 0)),
                        num_headlayers=int(a.get("num_headlayers", len(dims))),
                        dim_headlayers=tuple(int(d) for d in dims),
                        node_type=a.get("type"),
                    )
                )
            return tuple(out)

        task_weights = arch.get("task_weights") or [1.0] * len(arch["output_dim"])
        wsum = sum(abs(w) for w in task_weights)
        task_weights = tuple(w / wsum for w in task_weights)

        return ModelSpec(
            mpnn_type=arch["mpnn_type"],
            input_dim=int(arch["input_dim"]),
            hidden_dim=int(arch["hidden_dim"]),
            num_conv_layers=int(arch["num_conv_layers"]),
            output_dim=tuple(int(d) for d in arch["output_dim"]),
            output_type=tuple(arch["output_type"]),
            graph_heads=branches("graph"),
            node_heads=branches("node"),
            task_weights=task_weights,
            activation=arch.get("activation_function", "relu"),
            graph_pooling=arch.get("graph_pooling", "mean"),
            loss_type=training.get("loss_function_type", "mse"),
            freeze_conv_layers=bool(arch.get("freeze_conv_layers", False)),
            initial_bias=arch.get("initial_bias"),
            dropout=float(arch.get("dropout", 0.25)),
            global_attn_engine=arch.get("global_attn_engine") or None,
            global_attn_type=arch.get("global_attn_type") or None,
            global_attn_heads=int(arch.get("global_attn_heads") or 0),
            max_graph_nodes=arch.get("max_graph_nodes") or None,
            pe_dim=int(arch.get("pe_dim") or 0),
            equivariance=arch.get("equivariance"),
            radius=arch.get("radius"),
            max_neighbours=arch.get("max_neighbours"),
            pna_deg=tuple(arch["pna_deg"]) if arch.get("pna_deg") else None,
            radial_type=arch.get("radial_type"),
            num_gaussians=arch.get("num_gaussians"),
            num_filters=arch.get("num_filters"),
            num_radial=arch.get("num_radial"),
            envelope_exponent=arch.get("envelope_exponent"),
            num_spherical=arch.get("num_spherical"),
            basis_emb_size=arch.get("basis_emb_size"),
            int_emb_size=arch.get("int_emb_size"),
            out_emb_size=arch.get("out_emb_size"),
            num_before_skip=arch.get("num_before_skip"),
            num_after_skip=arch.get("num_after_skip"),
            max_ell=arch.get("max_ell"),
            node_max_ell=arch.get("node_max_ell"),
            correlation=(tuple(arch["correlation"])
                         if isinstance(arch.get("correlation"), list)
                         else arch.get("correlation")),
            avg_num_neighbors=arch.get("avg_num_neighbors"),
            enable_interatomic_potential=bool(arch.get("enable_interatomic_potential", False)),
            energy_weight=float(arch.get("energy_weight", 0.0)),
            energy_peratom_weight=float(arch.get("energy_peratom_weight", 0.0)),
            force_weight=float(arch.get("force_weight", 0.0)),
            edge_dim=int(arch.get("edge_dim") or len(arch.get("edge_features") or [])),
            use_graph_attr_conditioning=bool(arch.get("use_graph_attr_conditioning", False)),
            graph_attr_conditioning_mode=arch.get("graph_attr_conditioning_mode", "concat_node"),
            graph_attr_dim=int(arch.get("graph_attr_dim") or 0),
            var_output=training.get("loss_function_type") == "GaussianNLLLoss",
            num_nodes=arch.get("num_nodes"),
            graph_size_variable=bool(arch.get("graph_size_variable", False)),
            conv_checkpointing=bool(training.get("conv_checkpointing", False)),
        )


def get_log_name_config(config: dict) -> str:
    """The run's name, as the JAX package derives it from the config."""
    arch = config["NeuralNetwork"]["Architecture"]
    training = config["NeuralNetwork"]["Training"]
    name = config["Dataset"]["name"]
    trimmed = name[: name.rfind("_")] if name.rfind("_") > 0 else name
    weights = arch.get("task_weights") or [1.0] * len(arch["output_dim"])
    return (
        f"{arch['mpnn_type']}-r-{arch.get('radius')}-ncl-{arch['num_conv_layers']}"
        f"-hd-{arch['hidden_dim']}-ne-{training['num_epoch']}"
        f"-lr-{training['Optimizer']['learning_rate']}-bs-{training['batch_size']}"
        f"-data-{trimmed}"
        "-node_ft-"
        + "".join(str(x) for x in config["NeuralNetwork"]["Variables_of_interest"]
                  ["input_node_features"])
        + "-task_weights-"
        + "".join(f"{w}-" for w in weights)
    )


def save_config(config: dict, log_name: str, path: str = "./logs/") -> None:
    """Write the augmented config as ``<path>/<log_name>/config.json``."""
    fname = os.path.join(path, log_name, "config.json")
    os.makedirs(os.path.dirname(fname), exist_ok=True)
    with open(fname, "w") as f:
        json.dump(config, f, indent=4)
