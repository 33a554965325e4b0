"""HydraModel — the multi-headed GNN skeleton.

Counterpart of ``hydragnn_tpu/models/base.py``: the conv stack (each layer
wrapped in ``GPSConv`` under GPS, after the embedding of the node features
and Laplacian positional encodings) with per-layer graph-attribute
conditioning, masked batch norm (train or eval mode) and activation,
mean/add/max/min graph pooling, the graph and node heads of every branch,
the weighted multi-task loss and the per-head squared errors. Module names
follow the flax ones (``graph_convs[i]`` is flax's ``graph_convs_{i}``,
``feature_layers[i]`` is ``feature_norm_{i}``, ``graph_shared[b]`` is
``graph_shared_{b}``, ``heads_NN[k][b]`` is ``head{k}_{b}``, a conv head's
``heads_NN[k][b].conv{j}`` and ``.convout`` are ``head{k}_{b}_conv{j}`` and
``head{k}_{b}_convout``), so ``convert.load_jax_variables`` maps one onto
the other.

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

The options of the skeleton:

* graph-attribute conditioning after every conv, before its norm:
  ``film`` (``graph_conditioner`` gives a per-graph scale and shift of the
  first ``min(width, hidden)`` channels), ``concat_node`` (the attributes
  broadcast to the nodes, concatenated and projected back to
  ``hidden_dim`` by ``graph_concat_projector``), ``fuse_pool`` (the pooled
  vector and the attributes through ``graph_pool_projector``). The
  attributes' width is ``spec.graph_attr_dim``: the port builds these
  layers when it is constructed, and builds none at width 0;
* variance outputs (``GaussianNLLLoss``): each head is ``2 dim`` wide,
  the mean its first ``dim`` columns and the variance the square of the
  rest; the forward then returns ``(means, variances)``;
* node heads of type ``mlp``, ``mlp_per_node`` (one weight bank per node
  position, :class:`PerNodeMLP`) and ``conv`` (extra conv layers of the
  stack's class, :class:`ConvHead`);
* multibranch heads: every branch computes on the whole batch and a
  ``torch.where`` on ``dataset_id`` keeps each graph's rows (node heads by
  their graph's id), so the shapes stay static;
* ``conv_checkpointing``: each conv layer alone under
  ``common.checkpointed`` (flax's ``nn.remat`` of the conv class).

The halo route (``parallel/halo.py``) runs the same forward over one
rank's partition of a giant graph, through two hooks: ``layer_hook`` before
every conv layer after the first (the halo rows' refresh) and
``pool_reduce`` on the pooled vector (the ranks' partial readouts merged);
its loss sums the masked means' parts over the ranks (``loss(...,
group=)``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config.schema import ModelSpec
from ..graphs import segment
from ..graphs.graph import GraphBatch
from .common import (_NO_GROUP, MLP, Dense, MaskedBatchNorm, checkpointed, get_activation,
                     get_loss, lecun_normal_, local_node_index)
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

CONDITIONING_MODES = ("film", "concat_node", "fuse_pool")
NODE_HEAD_TYPES = ("mlp", "mlp_per_node", "conv")


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


def check_spec(spec: ModelSpec) -> None:
    """Raise ``ValueError`` for an unknown architecture, attention type,
    conditioning mode or node-head type."""
    if spec.mpnn_type not in CONV_REGISTRY:
        raise ValueError(f"unknown mpnn_type {spec.mpnn_type!r}; supported: "
                         f"{sorted(CONV_REGISTRY)}")
    if spec.global_attn_engine:
        if spec.global_attn_engine != "GPS":
            raise ValueError(f"unknown global_attn_engine {spec.global_attn_engine!r}")
        kind = spec.global_attn_type or "multihead"
        if kind not in ("multihead", "performer", "ring"):
            raise ValueError(f"unknown global_attn_type {spec.global_attn_type!r}")
    if (spec.use_graph_attr_conditioning
            and spec.graph_attr_conditioning_mode not in CONDITIONING_MODES):
        raise ValueError("graph_attr_conditioning_mode must be one of: "
                         "'film', 'concat_node', 'fuse_pool'")
    for b in spec.node_heads:
        if (b.node_type or "mlp") not in NODE_HEAD_TYPES:
            raise ValueError(f"Unknown node head type '{b.node_type}'; support 'mlp', "
                             "'mlp_per_node', 'conv'")


def branch_id(branch: str) -> int:
    """The ``dataset_id`` a branch answers: ``"branch-{n}"`` -> n."""
    return int(branch.split("-")[1])


class PerNodeMLP(nn.Module):
    """The ``mlp_per_node`` head: a separate MLP per node position of
    fixed-size graphs, as one weight bank ``w_{i} [num_nodes, in, out]`` and
    ``b_{i} [num_nodes, out]`` per layer, gathered by each node's position
    and applied as ``einsum("ni,nio->no")`` (flax's parameters and names;
    not a ``Dense``, so int8 serving leaves it fp32). The features and the
    banks are promoted to their common type, as ``jnp.einsum`` promotes."""

    def __init__(self, num_nodes: int, in_features: int, features, activation: str = "relu",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_nodes = int(num_nodes)
        self.features = tuple(int(f) for f in features)
        self.activation = activation
        d = in_features
        for i, f in enumerate(self.features):
            w = nn.Parameter(torch.empty(self.num_nodes, d, f))
            # flax's lecun_normal counts the bank axis as receptive field
            lecun_normal_(w, generator, fan_in=self.num_nodes * d)
            self.register_parameter(f"w_{i}", w)
            self.register_parameter(f"b_{i}", nn.Parameter(torch.zeros(self.num_nodes, f)))
            d = f

    def forward(self, x: torch.Tensor, local_idx: torch.Tensor) -> torch.Tensor:
        act = get_activation(self.activation)
        # padding nodes' positions past the bank clamp, as a JAX gather does
        idx = local_idx.clamp(max=self.num_nodes - 1)
        n = len(self.features)
        for i in range(n):
            w, b = getattr(self, f"w_{i}"), getattr(self, f"b_{i}")
            dtype = torch.promote_types(x.dtype, w.dtype)
            x = torch.einsum("ni,nio->no", x.to(dtype), w[idx].to(dtype)) + b[idx].to(dtype)
            if i < n - 1:
                x = act(x)
        return x


class ConvHead(nn.Module):
    """The ``conv`` node head: conv layers of the stack's own class after
    the encoder (``conv{j}``, one per head layer, at the class's width for
    layer ``num_conv_layers + j``), then ``convout`` with ``out_dim``
    outputs; no norm or activation between them."""

    def __init__(self, conv_cls, spec: ModelSpec, in_features: int, n_hidden: int,
                 out_dim: int, generator: torch.Generator | None = None):
        super().__init__()
        self.n_hidden = n_hidden
        width = in_features
        for j in range(n_hidden):
            layer = spec.num_conv_layers + j
            self.add_module(f"conv{j}", conv_cls(spec, layer, width, generator=generator))
            width = (width if getattr(conv_cls, "keeps_width", False)
                     else conv_cls.out_features(spec, layer))
        self.convout = conv_cls(spec, spec.num_conv_layers + n_hidden, width, out_dim=out_dim,
                                generator=generator)

    def forward(self, inv, equiv, batch: GraphBatch, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        for j in range(self.n_hidden):
            inv, equiv = getattr(self, f"conv{j}")(inv, equiv, batch, train, generator)
        return self.convout(inv, equiv, batch, train, generator)[0]


class HydraModel(nn.Module):
    """Multi-headed GNN over padded graph batches. Parameters are
    initialised as flax initialises them, from ``generator``."""

    def __init__(self, spec: ModelSpec, generator: torch.Generator | None = None):
        super().__init__()
        check_spec(spec)
        self.spec = spec
        conv_cls = base_cls = CONV_REGISTRY[spec.mpnn_type]
        # the stack's flags come from the architecture's own conv class,
        # GPS or not (SchNet, EGNN and the geometric stacks keep no feature
        # norm under GPS; MACE keeps its collected layer outputs)
        use_feature_norm = getattr(conv_cls, "feature_norm", True)
        self.stack_activation = getattr(conv_cls, "stack_activation", True)
        self.collect_layer_outputs = getattr(conv_cls, "collect_layer_outputs", False)
        hidden = spec.hidden_dim
        # the conditioning mode in force: none without attributes
        self.conditioning = (spec.graph_attr_conditioning_mode
                             if spec.use_graph_attr_conditioning and spec.graph_attr_dim > 0
                             else None)
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
        conv_out = []
        for i in range(spec.num_conv_layers):
            conv_out.append(conv_cls.out_features(spec, i))
            # concat_node projects every layer's output to hidden_dim
            widths.append(hidden if self.conditioning == "concat_node" else conv_out[-1])
        self.graph_convs = nn.ModuleList([
            conv_cls(spec, i, widths[i], generator=generator)
            for i in range(spec.num_conv_layers)
        ])
        # flax's feature_norm_{i}; a stack without feature norm (EGNN) has none
        self.feature_layers = nn.ModuleList([
            MaskedBatchNorm(widths[i + 1]) for i in range(spec.num_conv_layers)
        ] if use_feature_norm else [])
        # the node heads' input: the last layer's output, or every layer's
        # (MACE); the graph heads': its pooled vector, hidden_dim wide after
        # fuse_pool
        node_width = sum(widths[1:]) if self.collect_layer_outputs else widths[-1]
        pooled_width = hidden if self.conditioning == "fuse_pool" else node_width
        self.graph_shared = nn.ModuleDict()
        shared_out = {}
        for b in spec.graph_heads:
            if b.num_sharedlayers > 0 and b.dim_sharedlayers > 0:
                self.graph_shared[b.branch] = MLP(
                    pooled_width, (b.dim_sharedlayers,) * b.num_sharedlayers,
                    activation=spec.activation, act_last=True, generator=generator,
                )
                shared_out[b.branch] = b.dim_sharedlayers
            else:
                shared_out[b.branch] = pooled_width
        var_mult = 2 if spec.var_output else 1
        self._head_cols = head_columns(spec)
        self._node_local_needed = False
        self.heads_NN = nn.ModuleList()
        for kind, _, dim in self._head_cols:
            per_branch = nn.ModuleDict()
            for b in spec.graph_heads if kind == "graph" else spec.node_heads:
                feats = tuple(b.dim_headlayers[: b.num_headlayers]) + (dim * var_mult,)
                node_type = "mlp" if kind == "graph" else (b.node_type or "mlp")
                if node_type == "mlp":
                    in_f = shared_out[b.branch] if kind == "graph" else node_width
                    per_branch[b.branch] = MLP(in_f, feats, activation=spec.activation,
                                               generator=generator)
                elif node_type == "mlp_per_node":
                    if spec.num_nodes is None or spec.graph_size_variable:
                        raise ValueError("mlp_per_node requires fixed-size graphs (reference "
                                         "config_utils.py:240-249)")
                    self._node_local_needed = True
                    per_branch[b.branch] = PerNodeMLP(spec.num_nodes, node_width, feats,
                                                      spec.activation, generator)
                else:
                    per_branch[b.branch] = ConvHead(base_cls, spec, node_width,
                                                    len(b.dim_headlayers[: b.num_headlayers]),
                                                    dim * var_mult, generator)
            self.heads_NN.append(per_branch)
        # the conditioning layers, one of each shared by every conv layer
        ga = spec.graph_attr_dim
        if self.conditioning == "film":
            self.graph_conditioner = MLP(ga, (hidden, 2 * hidden), activation=spec.activation,
                                         generator=generator)
        elif self.conditioning == "concat_node":
            if len(set(conv_out)) > 1:
                raise ValueError(f"concat_node conditioning shares one projector across the "
                                 f"conv layers, whose widths differ: {conv_out}")
            self.graph_concat_projector = Dense(conv_out[0] + ga, hidden, generator)
        elif self.conditioning == "fuse_pool":
            self.graph_pool_projector = MLP(node_width + ga, (hidden, hidden),
                                            activation=spec.activation, generator=generator)

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
        """Conv layer ``i`` (checkpointed under ``conv_checkpointing`` where
        a gradient is taken) + graph-attribute conditioning + feature norm
        (batch statistics in train mode) + activation (unless the stack has
        none). ``generator`` draws the dropout masks in train mode."""
        conv = self.graph_convs[i]
        if self.spec.conv_checkpointing and torch.is_grad_enabled():
            # the recompute runs in the backward, after the step's
            # functional_call has put the fp32 masters back: it reads the
            # tensors this pass read (the compute-dtype casts)
            tensors = {**dict(conv.named_parameters()), **dict(conv.named_buffers())}
            inv, equiv = checkpointed(
                lambda h, e: torch.func.functional_call(conv, tensors,
                                                        (h, e, batch, train, generator)),
                inv, equiv)
        else:
            inv, equiv = conv(inv, equiv, batch, train, generator)
        inv = self.condition(inv, batch)
        if len(self.feature_layers):
            inv = self.feature_layers[i](inv, batch.node_mask, train)
        if self.stack_activation:
            inv = get_activation(self.spec.activation)(inv)
        return inv, equiv

    def condition(self, inv: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
        """A conv layer's node features conditioned on the graph attributes
        (``film`` and ``concat_node``; ``fuse_pool`` conditions in
        :meth:`pool`)."""
        if self.conditioning == "film":
            from ..ops.fused_scatter import gather_rows

            gb = self.graph_conditioner(batch.graph_attr)  # [G, 2H]
            # one gather of both halves to the nodes; its backward is the
            # segment-sum kernel over the batch's view on the card
            gbn = gather_rows(gb, batch.batch, batch.csr("batch") if gb.is_cuda else None)
            hidden = gb.shape[-1] // 2
            h = min(inv.shape[-1], hidden)
            if h == inv.shape[-1]:
                # no zero-width piece to concatenate: on the card, a
                # concatenation with one made the MLIP's double backward
                # differ from run to run
                return inv * (1.0 + gbn[:, :h]) + gbn[:, hidden:hidden + h]
            scaled = inv[:, :h] * (1.0 + gbn[:, :h]) + gbn[:, hidden:hidden + h]
            return torch.cat([scaled, inv[:, h:]], dim=-1)
        if self.conditioning == "concat_node":
            ga = batch.graph_attr[batch.batch]
            return self.graph_concat_projector(torch.cat([inv, ga], dim=-1))
        return inv

    def encode(self, batch: GraphBatch, train: bool = False,
               generator: torch.Generator | None = None, layer_hook=None):
        """The conv stack: the last layer's node features, or (MACE) every
        layer's concatenated, and the equivariant features.
        ``layer_hook(inv, equiv) -> (inv, equiv)`` runs before every layer
        after the first (the halo route's refresh of its halo rows)."""
        inv, equiv = self.embed(batch)
        outs = []
        for i in range(len(self.graph_convs)):
            if layer_hook is not None and i > 0:
                inv, equiv = layer_hook(inv, equiv)
            inv, equiv = self.conv_block(i, inv, equiv, batch, train, generator)
            outs.append(inv)
        if self.collect_layer_outputs:
            inv = torch.cat(outs, dim=-1)
        return inv, equiv

    def pool(self, x: torch.Tensor, batch: GraphBatch, pool_reduce=None) -> torch.Tensor:
        """The graph pooling (``fuse_pool``: fused with the graph
        attributes); ``pool_reduce`` merges the ranks' partial readouts of a
        partitioned node set before anything reads them (the halo
        route)."""
        data = x * batch.node_mask[:, None]
        use_kernel = data.is_cuda and self.spec.graph_pooling in ("add", "sum", "mean")
        pooled = segment.global_pool(
            self.spec.graph_pooling, data, batch.batch, batch.num_graphs,
            index=batch.csr("batch") if use_kernel else None,
        )
        if pool_reduce is not None:
            pooled = pool_reduce(pooled)
        if self.conditioning == "fuse_pool":
            pooled = self.graph_pool_projector(torch.cat([pooled, batch.graph_attr], dim=-1))
        return pooled

    # -- full forward --------------------------------------------------------
    def forward(self, batch: GraphBatch, train: bool = False,
                generator: torch.Generator | None = None, layer_hook=None, pool_reduce=None):
        """Per-head outputs (with ``var_output``: ``(means, variances)``);
        ``train`` normalises with batch statistics, updates the running ones
        in place and applies dropout with masks drawn from ``generator``.
        ``layer_hook`` and ``pool_reduce``: see :meth:`encode` and
        :meth:`pool`."""
        inv, equiv = self.encode(batch, train, generator, layer_hook=layer_hook)
        return self.decode(inv, equiv, batch, train, generator, pool_reduce=pool_reduce)

    def decode(self, inv: torch.Tensor, equiv: torch.Tensor, batch: GraphBatch,
               train: bool = False, generator: torch.Generator | None = None,
               pool_reduce=None):
        """Pooling + per-head decoders; one tensor per head (with
        ``var_output``: the means and the variances). With several branches
        each head's rows come from the branch of their graph's
        ``dataset_id``."""
        spec = self.spec
        x_graph = self.pool(inv, batch, pool_reduce)
        local_idx = (local_node_index(batch.batch, batch.n_node, batch.num_nodes)
                     if self._node_local_needed else None)
        outputs, variances = [], []
        for ihead, (kind, _, dim) in enumerate(self._head_cols):
            branches = spec.graph_heads if kind == "graph" else spec.node_heads
            rows = batch.num_graphs if kind == "graph" else batch.num_nodes
            out = out_var = None
            for b in branches:
                head = self.heads_NN[ihead][b.branch]
                if kind == "graph":
                    shared = self.graph_shared[b.branch] if b.branch in self.graph_shared else None
                    o = head(shared(x_graph) if shared is not None else x_graph)
                elif isinstance(head, ConvHead):
                    o = head(inv, equiv, batch, train, generator)
                elif isinstance(head, PerNodeMLP):
                    o = head(inv, local_idx)
                else:
                    o = head(inv)
                mu = o[:, :dim]
                var = o[:, dim:] ** 2 if spec.var_output else None
                if len(branches) == 1:
                    out, out_var = mu, var
                    continue
                if out is None:
                    out = inv.new_zeros((rows, dim))
                    out_var = inv.new_zeros((rows, dim))
                ids = batch.dataset_id if kind == "graph" else batch.dataset_id[batch.batch]
                sel = (ids == branch_id(b.branch))[:, None]
                out = torch.where(sel, mu, out)
                if var is not None:
                    out_var = torch.where(sel, var, out_var)
            outputs.append(out)
            variances.append(out_var)
        if spec.var_output:
            return outputs, variances
        return outputs

    # -- loss ----------------------------------------------------------------
    def _targets(self, batch: GraphBatch):
        """Per head: (target columns, row mask)."""
        for kind, col, dim in self._head_cols:
            if kind == "graph":
                yield batch.graph_y[:, col : col + dim], batch.graph_mask
            else:
                yield batch.node_y[:, col : col + dim], batch.node_mask

    def loss(self, pred, batch: GraphBatch, group=_NO_GROUP):
        """Weighted multi-task loss: (total, [per-task losses]), the tasks
        weighted by ``spec.task_weights`` and summed in head order; with
        ``var_output`` ``pred`` is ``(means, variances)``. ``group``: the
        process group whose ranks hold partitions of the node rows (the
        halo route), over which each masked mean sums its parts."""
        var = None
        if self.spec.var_output:
            pred, var = pred
        loss_fn = get_loss(self.spec.loss_type)
        tot = 0.0
        tasks = []
        for ihead, (target, mask) in enumerate(self._targets(batch)):
            if var is not None:
                task_loss = loss_fn(pred[ihead], target, mask, var[ihead], group=group)
            else:
                task_loss = loss_fn(pred[ihead], target, mask, group=group)
            tot = tot + task_loss * self.spec.task_weights[ihead]
            tasks.append(task_loss)
        return tot, tasks

    def head_sse(self, pred, batch: GraphBatch):
        """Per-head (sum of squared errors, element count) over real rows
        (of the means, with ``var_output``); callers sum these over a split
        and take one sqrt at the end."""
        if self.spec.var_output:
            pred = pred[0]
        sses, counts = [], []
        for ihead, (target, mask) in enumerate(self._targets(batch)):
            sses.append((((pred[ihead] - target) ** 2) * mask[:, None]).sum())
            counts.append(mask.sum() * target.shape[1])
        return sses, counts


__all__ = ["CONDITIONING_MODES", "CONV_REGISTRY", "ConvHead", "HydraModel", "NODE_HEAD_TYPES",
           "PerNodeMLP", "branch_id", "check_spec", "head_columns"]
