"""MLIP: energy-conserving interatomic potentials, forces from the gradient
of the energy in the positions.

Counterpart of ``hydragnn_tpu/models/mlip.py``. The model's graph energy is
a function of the positions; forces are ``-torch.autograd.grad(E.sum(),
pos)`` (``create_graph=True`` in training), and the parameter gradient of
the energy+force loss is a gradient of that gradient. On the card every
segment reduction of it stays on the port's kernels: their backwards are
the port's own differentiable Functions (``ops/fused_scatter.py``).

Loss (reference ``create.py:626-738``):

    L = w_E loss(E, E_true) + w_Ea loss(E / n_atoms, E_true / n_atoms)
        + w_F loss(F, F_true)

with the task losses reported as [energy, energy_per_atom, force].
Constraints kept from the reference: exactly one output head; a graph head
needs sum pooling; a node head is summed into a graph energy. A
``var_output`` model's energy is its head's mean; graph-attribute
conditioning reads the batch's ``graph_attr`` in the forward, as in every
other model.
"""

from __future__ import annotations

import warnings

import torch

from ..config.schema import ModelSpec
from ..graphs import segment
from ..graphs.graph import GraphBatch
from .common import get_loss


def validate_mlip_spec(spec: ModelSpec) -> None:
    if spec.num_heads != 1:
        raise ValueError("Force predictions require exactly one head (create.py:646-648)")
    if spec.activation in ("relu", "lrelu_01", "lrelu_025", "lrelu_05"):
        warnings.warn(
            "Force training with piecewise-linear activations (relu/leaky-relu) learns "
            "poorly: forces are energy gradients, and dE/dr is piecewise-constant under "
            "relu. Use 'silu', 'tanh', or 'gelu' (set "
            "NeuralNetwork.Architecture.activation_function)."
        )
    if spec.output_type[0] == "graph" and spec.graph_pooling not in ("add", "sum"):
        raise ValueError("Graph head force loss requires sum pooling (graph_pooling='add')")
    if spec.energy_weight <= 0 and spec.energy_peratom_weight <= 0 and spec.force_weight <= 0:
        raise ValueError(
            "All interatomic potential loss weights are zero; set at least one of "
            "energy_weight, energy_peratom_weight, or force_weight"
        )


def graph_energy(spec: ModelSpec, head: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    """Per-graph energies ``[G]`` from the one head's output (padding graphs
    0): a graph head's column, or a node head summed per graph (through the
    segment-sum kernel on the card)."""
    if spec.output_type[0] == "node":
        node_e = head[:, :1] * batch.node_mask[:, None]
        index = batch.csr("batch") if node_e.is_cuda else None
        graph_e = segment.segment_sum(node_e, batch.batch, batch.num_graphs, index=index)[:, 0]
    else:
        graph_e = head[:, 0]
    return graph_e * batch.graph_mask


def make_graph_energy_fn(model):
    """``(batch, train=False) -> per-graph energies [G]`` at
    ``batch.pos``."""
    spec = model.spec

    def energy_fn(batch: GraphBatch, train: bool = False) -> torch.Tensor:
        out = model(batch, train=train)
        return graph_energy(spec, (out[0] if spec.var_output else out)[0], batch)

    return energy_fn


def make_energy_and_forces(model):
    """``(batch, train=False) -> (graph energies [G], forces [N, 3])``:
    ``forces = -dE/dpos`` with ``E`` the sum of the graph energies (every
    atom belongs to one graph, so the summed gradient is the per-atom
    force), zero on padded nodes."""
    energy_fn = make_graph_energy_fn(model)

    def energy_and_forces(batch: GraphBatch, train: bool = False):
        with torch.enable_grad():
            pos = batch.pos.detach().requires_grad_(True)
            graph_e = energy_fn(batch.replace(pos=pos), train)
            (grad_pos,) = torch.autograd.grad(graph_e.sum(), pos)
        return graph_e.detach(), -grad_pos * batch.node_mask[:, None]

    return energy_and_forces


def energy_force_loss(spec: ModelSpec, graph_e: torch.Tensor, forces: torch.Tensor,
                      batch: GraphBatch):
    """``(total loss, [energy, energy_per_atom, force] task losses)``."""
    loss_fn = get_loss(spec.loss_type)
    gmask = batch.graph_mask
    e_true = batch.energy_y[:, 0]
    e_loss = loss_fn(graph_e[:, None], e_true[:, None], gmask)
    natoms = torch.clamp(batch.n_node.to(graph_e.dtype), min=1.0)
    ea_loss = loss_fn((graph_e / natoms)[:, None], (e_true / natoms)[:, None], gmask)
    f_loss = loss_fn(forces, batch.forces_y, batch.node_mask)
    tot = (spec.energy_weight * e_loss + spec.energy_peratom_weight * ea_loss
           + spec.force_weight * f_loss)
    return tot, [e_loss, ea_loss, f_loss]


def _position_leaf(batch: GraphBatch):
    """``batch`` with its positions replaced by a fresh leaf that requires
    grad (the id arrays' CSR cache kept), and the leaf."""
    pos = batch.pos.detach().requires_grad_(True)
    b = batch.replace(pos=pos)
    b._csr = batch._csr
    return b, pos


def make_mlip_train_step(model, compute_dtype: torch.dtype = torch.float32,
                         loss_scale: float | None = None):
    """``(state, batch) -> metrics``: one optimizer step on the
    energy+force loss. The train-mode forward runs once, at a position leaf
    (its dropout masks and batch-statistics update serve the energy and its
    position gradient alike); forces are that gradient with
    ``create_graph=True``, so the loss's backward reaches the parameters
    through it. ``loss_scale`` scales the outer objective only: the forces
    stay in physical units, as the JAX step keeps them."""
    from ..train.step import optimizer_step

    loss_scale = None if not loss_scale or float(loss_scale) == 1.0 else float(loss_scale)
    loss = make_mlip_train_loss(model, compute_dtype)

    def train_step(state, batch: GraphBatch) -> dict:
        tot, tasks = loss(state, batch)
        return optimizer_step(state, batch, tot, tasks, loss_scale)

    return train_step


def make_mlip_train_loss(model, compute_dtype: torch.dtype = torch.float32):
    """``(state, batch) -> (total loss, [task losses])``: the MLIP train
    step's forward, forces and energy+force loss, before its backward."""
    from ..train.step import cast_forward, head_means

    spec = model.spec
    validate_mlip_spec(spec)

    def train_loss(state, batch: GraphBatch):
        b, pos = _position_leaf(batch)
        pred = head_means(state.model, cast_forward(state.model, b, compute_dtype, train=True,
                                                    generator=state.generator))
        graph_e = graph_energy(spec, pred[0], batch).to(torch.float32)
        (grad_pos,) = torch.autograd.grad(graph_e.sum(), pos, create_graph=True)
        forces = (-grad_pos * batch.node_mask[:, None]).to(torch.float32)
        return energy_force_loss(spec, graph_e, forces, batch)

    return train_loss


def make_mlip_eval_step(model, compute_dtype: torch.dtype = torch.float32):
    """``(state, batch) -> metrics`` with the loss, the task losses and the
    squared errors and element counts of [energy, force] (``head_sse``,
    ``head_count``); eval-mode forward, forces without a graph for a second
    derivative, no update."""
    from ..train.step import cast_forward, head_means

    spec = model.spec

    def eval_step(state, batch: GraphBatch) -> dict:
        with torch.enable_grad():
            b, pos = _position_leaf(batch)
            pred = head_means(state.model, cast_forward(state.model, b, compute_dtype,
                                                        train=False))
            graph_e = graph_energy(spec, pred[0], batch).to(torch.float32)
            (grad_pos,) = torch.autograd.grad(graph_e.sum(), pos)
        with torch.no_grad():
            graph_e = graph_e.detach()
            forces = (-grad_pos * batch.node_mask[:, None]).to(torch.float32)
            tot, tasks = energy_force_loss(spec, graph_e, forces, batch)
            gm = batch.graph_mask
            e_sse = (((graph_e - batch.energy_y[:, 0]) ** 2) * gm).sum()
            f_sse = (((forces - batch.forces_y) ** 2) * batch.node_mask[:, None]).sum()
            return {
                "loss": tot,
                "tasks_loss": torch.stack(tasks),
                "head_sse": torch.stack([e_sse, f_sse]),
                "head_count": torch.stack([gm.sum(), batch.node_mask.sum() * 3]),
                "num_graphs": gm.sum(),
            }

    return eval_step


__all__ = [
    "energy_force_loss",
    "graph_energy",
    "make_energy_and_forces",
    "make_graph_energy_fn",
    "make_mlip_eval_step",
    "make_mlip_train_loss",
    "make_mlip_train_step",
    "validate_mlip_spec",
]
