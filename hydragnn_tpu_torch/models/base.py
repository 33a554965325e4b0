"""HydraModel — the multi-headed GNN skeleton.

Counterpart of ``hydragnn_tpu/models/base.py`` as far as the GIN, GAT and
GPS-GIN serving and training paths need it: the conv stack (each layer
wrapped in ``GPSConv`` under GPS, after the embedding of the node features
and Laplacian positional encodings) with per-layer masked batch norm (train
or eval mode) and activation, mean/add/max/min graph pooling,
single-branch ``mlp`` graph and node heads, the weighted multi-task loss and
the per-head squared errors. Module names follow the flax ones (``graph_convs[i]`` is flax's
``graph_convs_{i}``, ``feature_layers[i]`` is ``feature_norm_{i}``,
``graph_shared[b]`` is ``graph_shared_{b}``, ``heads_NN[k][b]`` is
``head{k}_{b}``), so ``convert.load_jax_variables`` maps one onto the other.

The EGNN stack carries positions through the layers as ``equiv``
and has no feature norm (a conv class with ``feature_norm = False`` gets no
norm layer); it is the MLIP path's model (``models/mlip.py``).

The invariant stacks SAGE, MFC, SchNet, PNA, PNAPlus and CGCNN run the
same skeleton (SchNet without feature norm, CGCNN at its input width), and
so do the geometric stacks PAINN, PNAEq, DimeNet and MACE, without feature
norm; PAINN and PNAEq carry a vector channel ``[N, 3, F]`` as ``equiv``,
MACE its packed irreps. A conv class may set ``stack_activation = False``
(no activation after the layer) and ``collect_layer_outputs = True`` (the
heads read every layer's output, concatenated): MACE sets both.

The ten ``EDGE_MODELS`` stacks read edge features (``edge_dim > 0``);
GPS wraps any conv, with multihead or performer attention
(``models/gps.py``). The stack's flags (feature norm, activation, collected
layer outputs) are always the architecture's own conv class's, GPS or not.

Not in this slice (they raise ``NotImplementedError``): GPS ring attention,
variance outputs, graph-attribute conditioning, ``mlp_per_node`` and
``conv`` node heads, multibranch heads.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config.schema import ModelSpec
from ..graphs import segment
from ..graphs.graph import GraphBatch
from .common import MLP, Dense, MaskedBatchNorm, get_activation, get_loss
from .cgcnn import CGCNNConv
from .dimenet import DimeNetConv
from .egnn import EGNNConv
from .gat import GATConv
from .gin import GINConv
from .mace import MACEConv
from .mfc import MFCConv
from .painn import PaiNNConv
from .pna import PNAConv
from .pnaeq import PNAEqConv
from .pnaplus import PNAPlusConv
from .sage import SAGEConv
from .schnet import SchNetConv

CONV_REGISTRY = {"GIN": GINConv, "GAT": GATConv, "EGNN": EGNNConv, "SAGE": SAGEConv,
                 "MFC": MFCConv, "SchNet": SchNetConv, "PNA": PNAConv, "PNAPlus": PNAPlusConv,
                 "CGCNN": CGCNNConv, "PAINN": PaiNNConv, "PNAEq": PNAEqConv,
                 "DimeNet": DimeNetConv, "MACE": MACEConv}


def head_columns(spec: ModelSpec) -> list[tuple[str, int, int]]:
    """Per-head (kind, column_start, dim) into the columnar target arrays."""
    cols = []
    g_off = n_off = 0
    for dim, kind in zip(spec.output_dim, spec.output_type):
        if kind == "graph":
            cols.append(("graph", g_off, dim))
            g_off += dim
        else:
            cols.append(("node", n_off, dim))
            n_off += dim
    return cols


def _not_in_slice(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet; it comes with {where}")


def check_spec(spec: ModelSpec) -> None:
    """Raise ``NotImplementedError`` for what this slice of the port lacks."""
    if spec.mpnn_type not in CONV_REGISTRY:
        raise ValueError(f"unknown mpnn_type {spec.mpnn_type!r}; supported: "
                         f"{sorted(CONV_REGISTRY)}")
    if spec.global_attn_engine:
        if spec.global_attn_engine != "GPS":
            raise ValueError(f"unknown global_attn_engine {spec.global_attn_engine!r}")
        kind = spec.global_attn_type or "multihead"
        if kind == "ring":
            raise _not_in_slice("GPS ring attention", "a later slice (parallelism)")
        if kind not in ("multihead", "performer"):
            raise ValueError(f"unknown global_attn_type {spec.global_attn_type!r}")
    if spec.var_output:
        raise _not_in_slice("variance outputs (GaussianNLLLoss)", "a later slice")
    if spec.use_graph_attr_conditioning:
        raise _not_in_slice("graph-attribute conditioning", "a later slice")
    if len(spec.graph_heads) > 1 or len(spec.node_heads) > 1:
        raise _not_in_slice("multibranch heads", "a later slice")
    for b in spec.node_heads:
        if (b.node_type or "mlp") != "mlp":
            raise _not_in_slice(f"node head type {b.node_type!r}", "a later slice")


class HydraModel(nn.Module):
    """Multi-headed GNN over padded graph batches. Parameters are
    initialised as flax initialises them, from ``generator``."""

    def __init__(self, spec: ModelSpec, generator: torch.Generator | None = None):
        super().__init__()
        check_spec(spec)
        self.spec = spec
        conv_cls = CONV_REGISTRY[spec.mpnn_type]
        # the stack's flags come from the architecture's own conv class,
        # GPS or not (SchNet, EGNN and the geometric stacks keep no feature
        # norm under GPS; MACE keeps its collected layer outputs)
        use_feature_norm = getattr(conv_cls, "feature_norm", True)
        self.stack_activation = getattr(conv_cls, "stack_activation", True)
        self.collect_layer_outputs = getattr(conv_cls, "collect_layer_outputs", False)
        hidden = spec.hidden_dim
        self.gps = spec.global_attn_engine == "GPS"
        if self.gps:
            # every layer is local conv + global attention over hidden-wide
            # features: the node features and positional encodings are
            # embedded first
            from .gps import GPSConv as conv_cls  # noqa: F811

            self.pos_emb = Dense(spec.pe_dim or 1, hidden, generator, use_bias=False)
            if spec.input_dim:
                self.node_emb = Dense(spec.input_dim, hidden, generator, use_bias=False)
                self.node_lin = Dense(2 * hidden, hidden, generator, use_bias=False)
        widths = [spec.input_dim if not self.gps else hidden]
        for i in range(spec.num_conv_layers):
            widths.append(conv_cls.out_features(spec, i))
        self.graph_convs = nn.ModuleList([
            conv_cls(spec, i, widths[i], generator=generator)
            for i in range(spec.num_conv_layers)
        ])
        # flax's feature_norm_{i}; a stack without feature norm (EGNN) has none
        self.feature_layers = nn.ModuleList([
            MaskedBatchNorm(widths[i + 1]) for i in range(spec.num_conv_layers)
        ] if use_feature_norm else [])
        # the heads' input: the last layer's output, or every layer's (MACE)
        hidden = sum(widths[1:]) if self.collect_layer_outputs else widths[-1]
        self.graph_shared = nn.ModuleDict()
        shared_out = {}
        for b in spec.graph_heads:
            if b.num_sharedlayers > 0 and b.dim_sharedlayers > 0:
                self.graph_shared[b.branch] = MLP(
                    hidden, (b.dim_sharedlayers,) * b.num_sharedlayers,
                    activation=spec.activation, act_last=True, generator=generator,
                )
                shared_out[b.branch] = b.dim_sharedlayers
            else:
                shared_out[b.branch] = hidden
        self._head_cols = head_columns(spec)
        self.heads_NN = nn.ModuleList()
        for kind, _, dim in self._head_cols:
            per_branch = nn.ModuleDict()
            for b in spec.graph_heads if kind == "graph" else spec.node_heads:
                feats = tuple(b.dim_headlayers[: b.num_headlayers]) + (dim,)
                in_f = shared_out[b.branch] if kind == "graph" else hidden
                per_branch[b.branch] = MLP(in_f, feats, activation=spec.activation,
                                           generator=generator)
            self.heads_NN.append(per_branch)

    # -- encoder ------------------------------------------------------------
    def embed(self, batch: GraphBatch):
        """Raw node features and positions (each stack's first conv lifts);
        under GPS the positional encodings embedded, and fused with the
        embedded node features."""
        if not self.gps:
            return batch.x, batch.pos
        if batch.pe.shape[1] == 0:
            raise ValueError("GPS needs Laplacian positional encodings; set pe_dim > 0 and "
                             "attach them in preprocessing (attach_lap_pe)")
        x = self.pos_emb(batch.pe)
        if self.spec.input_dim:
            x = self.node_lin(torch.cat([self.node_emb(batch.x), x], dim=1))
        return x, batch.pos

    def conv_block(self, i: int, inv: torch.Tensor, equiv: torch.Tensor, batch: GraphBatch,
                   train: bool = False, generator: torch.Generator | None = None):
        """Conv layer ``i`` + feature norm (batch statistics in train mode)
        + activation (unless the stack has none). ``generator`` draws the
        dropout masks in train mode."""
        inv, equiv = self.graph_convs[i](inv, equiv, batch, train, generator)
        if len(self.feature_layers):
            inv = self.feature_layers[i](inv, batch.node_mask, train)
        if self.stack_activation:
            inv = get_activation(self.spec.activation)(inv)
        return inv, equiv

    def encode(self, batch: GraphBatch, train: bool = False,
               generator: torch.Generator | None = None):
        """The conv stack: the last layer's node features, or (MACE) every
        layer's concatenated, and the equivariant features."""
        inv, equiv = self.embed(batch)
        outs = []
        for i in range(len(self.graph_convs)):
            inv, equiv = self.conv_block(i, inv, equiv, batch, train, generator)
            outs.append(inv)
        if self.collect_layer_outputs:
            inv = torch.cat(outs, dim=-1)
        return inv, equiv

    def pool(self, x: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
        data = x * batch.node_mask[:, None]
        use_kernel = data.is_cuda and self.spec.graph_pooling in ("add", "sum", "mean")
        return segment.global_pool(
            self.spec.graph_pooling, data, batch.batch, batch.num_graphs,
            index=batch.csr("batch") if use_kernel else None,
        )

    # -- full forward --------------------------------------------------------
    def forward(self, batch: GraphBatch, train: bool = False,
                generator: torch.Generator | None = None):
        """Per-head outputs; ``train`` normalises with batch statistics,
        updates the running ones in place and applies dropout with masks
        drawn from ``generator``."""
        inv, equiv = self.encode(batch, train, generator)
        return self.decode(inv, equiv, batch)

    def decode(self, inv: torch.Tensor, equiv: torch.Tensor, batch: GraphBatch):
        """Pooling + per-head decoders; returns one tensor per head."""
        x_graph = self.pool(inv, batch)
        outputs = []
        for ihead, (kind, _, dim) in enumerate(self._head_cols):
            (branch, head), = self.heads_NN[ihead].items()
            if kind == "graph":
                shared = self.graph_shared[branch] if branch in self.graph_shared else None
                o = head(shared(x_graph) if shared is not None else x_graph)
            else:
                o = head(inv)
            outputs.append(o[:, :dim])
        return outputs

    # -- loss ----------------------------------------------------------------
    def _targets(self, batch: GraphBatch):
        """Per head: (target columns, row mask)."""
        for kind, col, dim in self._head_cols:
            if kind == "graph":
                yield batch.graph_y[:, col : col + dim], batch.graph_mask
            else:
                yield batch.node_y[:, col : col + dim], batch.node_mask

    def loss(self, pred, batch: GraphBatch):
        """Weighted multi-task loss: (total, [per-task losses]), the tasks
        weighted by ``spec.task_weights`` and summed in head order."""
        loss_fn = get_loss(self.spec.loss_type)
        tot = 0.0
        tasks = []
        for ihead, (target, mask) in enumerate(self._targets(batch)):
            task_loss = loss_fn(pred[ihead], target, mask)
            tot = tot + task_loss * self.spec.task_weights[ihead]
            tasks.append(task_loss)
        return tot, tasks

    def head_sse(self, pred, batch: GraphBatch):
        """Per-head (sum of squared errors, element count) over real rows;
        callers sum these over a split and take one sqrt at the end."""
        sses, counts = [], []
        for ihead, (target, mask) in enumerate(self._targets(batch)):
            sses.append((((pred[ihead] - target) ** 2) * mask[:, None]).sum())
            counts.append(mask.sum() * target.shape[1])
        return sses, counts


__all__ = ["CONV_REGISTRY", "HydraModel", "check_spec", "head_columns"]
