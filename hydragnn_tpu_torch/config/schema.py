"""Config system: the reference JSON schema, validated and augmented.

Counterpart of ``hydragnn_tpu/config/schema.py`` as far as the serving path
needs it: ``load_config``, ``update_config`` (default filling, multibranch
head normalisation, output dims/types from the ``Dataset`` feature dims,
input dim) and the typed ``ModelSpec`` view the model factory reads. The
derivations for other conv stacks (PNA degrees, MACE neighbour counts,
edge features, GPS widths) and the blocks of subsystems the port does not
have yet come with their slices.
"""

from __future__ import annotations

import dataclasses
import json
import os
from copy import deepcopy

CONFIG_SECTIONS = frozenset(
    {"Verbosity", "Dataset", "NeuralNetwork", "Visualization", "Serving",
     "MD", "Telemetry", "Screening"}
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
    from ..serve.server import ServingConfig, serving_config_defaults

    ServingConfig.from_config(config).validate()
    for key, val in serving_config_defaults().items():
        serving_cfg.setdefault(key, val)

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
    arch["input_dim"] = len(voi.get("input_node_features", []))

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
    # read only to refuse what this slice of the port does not run
    global_attn_engine: str | None = None
    use_graph_attr_conditioning: bool = False
    enable_interatomic_potential: bool = False
    var_output: bool = False

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
            global_attn_engine=arch.get("global_attn_engine") or None,
            use_graph_attr_conditioning=bool(arch.get("use_graph_attr_conditioning", False)),
            enable_interatomic_potential=bool(arch.get("enable_interatomic_potential", False)),
            var_output=training.get("loss_function_type") == "GaussianNLLLoss",
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
