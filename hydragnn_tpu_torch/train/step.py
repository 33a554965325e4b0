"""Precision policy, the train state and the train, eval and predict steps.

Counterpart of ``hydragnn_tpu/train/step.py``. Every step casts the fp32
master parameters and the batch's floating fields to the compute dtype,
leaves the batch-norm running statistics fp32 (the JAX steps pass
``batch_stats`` uncast), and casts the outputs to fp32 before the loss. With
bf16 this means only the first conv layer runs bf16: the first feature norm
promotes to fp32 against its fp32 statistics, and every later layer computes
fp32 with bf16-rounded weights, exactly as in the JAX package.

The train step follows the JAX ``_make_step_impl``: the casts happen inside
the differentiated function (``torch.func.functional_call`` over the cast
parameters), so their backward hands fp32 gradients to the fp32 masters; no
``torch.autocast``. A static ``loss_scale`` multiplies the loss before the
backward and divides the fp32 gradients after it; the metrics are unscaled.

Dropout (GAT's attention, GPS) draws its masks from the train state's
``torch.Generator``, seeded from the run's seed; the eval and predict steps
draw nothing.

These are the eager steps. On the card the epoch loop, the server and
``run_prediction`` replay them as CUDA graphs (``capture.py``), and the
eager steps stay the comparator the card's tests and ``chip_smoke.py`` call
directly. Nothing in them waits for the host, so they can be captured: the
gradients that ``optimizer_step`` creates and fills are fixed by the
model's structure (the same parameters get none at every step), and the
optimizers on the card are capturable (``train/optimizer.py``).
"""

from __future__ import annotations

import dataclasses

import torch

PRECISION_MAP = {
    "fp32": torch.float32,
    "float32": torch.float32,
    "fp64": torch.float64,
    "float64": torch.float64,
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "fp16": torch.float16,
    "float16": torch.float16,
}

# "auto": bf16 compute on the card, fp32 elsewhere
KNOWN_PRECISIONS = frozenset(PRECISION_MAP) | {"auto"}


def resolve_precision(name: str, device) -> torch.dtype:
    """The compute dtype of ``Training.precision`` on ``device`` ("auto":
    bf16 on the card, fp32 elsewhere)."""
    if name == "auto":
        return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    try:
        return PRECISION_MAP[name]
    except KeyError:
        raise ValueError(
            f"Unknown precision '{name}'; one of {sorted(KNOWN_PRECISIONS)}"
        ) from None


def resolve_loss_scale(training_cfg: dict) -> float | None:
    """``Training.loss_scale``; None when unset, 0 or 1 (no scaling)."""
    scale = float(training_cfg.get("loss_scale", 0) or 0)
    return scale if scale not in (0.0, 1.0) else None


@dataclasses.dataclass
class TrainState:
    """The model (fp32 master parameters, running statistics), its
    optimizer, the number of steps taken and the generator of the dropout
    masks (on the model's device). The steps update them in place."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    generator: torch.Generator | None = None


def apply_initial_bias(model: torch.nn.Module) -> torch.nn.Module:
    """``Architecture.initial_bias``: fill the last dense layer's bias of
    every graph head's branches."""
    bias = model.spec.initial_bias
    if bias is None:
        return model
    with torch.no_grad():
        for ihead, kind in enumerate(model.spec.output_type):
            if kind != "graph":
                continue
            for mlp in model.heads_NN[ihead].values():
                getattr(mlp, f"dense_{len(mlp.features) - 1}").bias.fill_(float(bias))
    return model


def create_train_state(model: torch.nn.Module, optimizer_config: dict,
                       seed: int = 0) -> TrainState:
    """Initial bias applied, then the ``Training.Optimizer`` optimizer over
    the model's parameters, and the dropout generator seeded from ``seed``
    on the model's device."""
    from .optimizer import select_optimizer

    apply_initial_bias(model)
    device = next(model.parameters()).device
    return TrainState(model=model,
                      optimizer=select_optimizer(optimizer_config, model.parameters()),
                      generator=torch.Generator(device=device).manual_seed(int(seed)))


def freeze_conv_grads(model: torch.nn.Module) -> None:
    """``freeze_conv_layers``: zero the gradients of the conv stack and the
    feature norms; the heads keep training (the optimizer still steps the
    frozen parameters with zero gradients, as optax does)."""
    if not model.spec.freeze_conv_layers:
        return
    for module in (model.graph_convs, model.feature_layers):
        for p in module.parameters():
            p.grad.zero_()


def cast_forward(model: torch.nn.Module, batch, compute_dtype: torch.dtype, train: bool,
                 generator: torch.Generator | None = None):
    """The model's per-head outputs (with ``var_output``: ``(means,
    variances)``), as fp32, with its parameters and the batch's floating
    fields cast to ``compute_dtype`` and the running statistics left as
    they are; ``generator`` draws the dropout masks in train mode."""
    params = {
        n: (p.to(compute_dtype) if p.is_floating_point() else p)
        for n, p in model.named_parameters()
    }
    buffers = dict(model.named_buffers())
    c_batch = batch.map_floats(lambda t: t.to(compute_dtype))
    outputs = torch.func.functional_call(model, {**params, **buffers}, (c_batch,),
                                         {"train": train, "generator": generator})
    if model.spec.var_output:
        means, variances = outputs
        return ([o.to(torch.float32) for o in means],
                [v.to(torch.float32) for v in variances])
    return [o.to(torch.float32) for o in outputs]


def head_means(model: torch.nn.Module, outputs):
    """The per-head means of :func:`cast_forward`'s outputs (its variances
    dropped under ``var_output``)."""
    return outputs[0] if model.spec.var_output else outputs


def make_train_step(compute_dtype: torch.dtype = torch.float32, loss_scale: float | None = None):
    """``(state, batch) -> metrics``: one optimizer step on a batch on the
    model's device. The metrics (``loss``, ``tasks_loss``, ``num_graphs``)
    stay on the device."""
    loss_scale = None if not loss_scale or float(loss_scale) == 1.0 else float(loss_scale)

    def train_step(state: TrainState, batch) -> dict:
        model = state.model
        pred = cast_forward(model, batch, compute_dtype, train=True,
                            generator=state.generator)
        tot, tasks = model.loss(pred, batch)
        return optimizer_step(state, batch, tot, tasks, loss_scale)

    return train_step


def optimizer_step(state: TrainState, batch, tot: torch.Tensor, tasks,
                   loss_scale: float | None = None) -> dict:
    """The backward of ``tot`` (times ``loss_scale``; the fp32 gradients
    divided back), zero gradients for parameters that got none (optax steps
    every parameter), the frozen conv stack, one optimizer step; returns the
    step's metrics (``loss``, ``tasks_loss``, ``num_graphs``), on the
    device."""
    model, optimizer = state.model, state.optimizer
    optimizer.zero_grad()
    (tot * loss_scale if loss_scale is not None else tot).backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        elif loss_scale is not None:
            p.grad.div_(loss_scale)
    freeze_conv_grads(model)
    optimizer.step()
    state.step += 1
    return {
        "loss": tot.detach(),
        "tasks_loss": torch.stack([t.detach() for t in tasks]),
        "num_graphs": batch.graph_mask.sum(),
    }


def make_eval_step(compute_dtype: torch.dtype = torch.float32):
    """``(state, batch) -> metrics`` with the per-head squared errors and
    element counts; eval-mode norms, no update."""

    def eval_step(state: TrainState, batch) -> dict:
        model = state.model
        with torch.no_grad():
            pred = cast_forward(model, batch, compute_dtype, train=False)
            tot, tasks = model.loss(pred, batch)
            sses, counts = model.head_sse(pred, batch)
        return {
            "loss": tot,
            "tasks_loss": torch.stack(tasks),
            "head_sse": torch.stack(sses),
            "head_count": torch.stack(counts),
            "num_graphs": batch.graph_mask.sum(),
        }

    return eval_step


def make_predict_step(model: torch.nn.Module, compute_dtype: torch.dtype = torch.float32):
    """``batch -> per-head fp32 predictions`` (with ``var_output``:
    ``(means, variances)``) for a batch on the model's device, under
    ``torch.inference_mode``."""

    def predict_step(batch):
        with torch.inference_mode():
            return cast_forward(model, batch, compute_dtype, train=False)

    return predict_step


__all__ = [
    "KNOWN_PRECISIONS",
    "PRECISION_MAP",
    "TrainState",
    "apply_initial_bias",
    "cast_forward",
    "create_train_state",
    "freeze_conv_grads",
    "head_means",
    "make_eval_step",
    "make_predict_step",
    "make_train_step",
    "optimizer_step",
    "resolve_loss_scale",
    "resolve_precision",
]
