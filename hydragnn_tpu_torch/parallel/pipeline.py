"""Pipeline parallelism: GPipe microbatch pipelining of the conv stack over
the ranks of a process group, one stage per process.

Counterpart of ``hydragnn_tpu/parallel/pipeline.py`` (``:73-444``), for deep
stacks whose weights or activations outgrow one card but whose widths do
not call for tensor sharding.

Layout (:class:`PipelineLayout`). Every rank is a stage (S = the world).
The input embedding with conv block 0 (the prologue, the one block that
lifts ``input_dim`` to ``hidden_dim``) and the decode epilogue (pooling and
heads) run replicated on every stage. Conv blocks ``1..L-1`` must be
parameter-homogeneous; stage ``s`` owns blocks ``1 + s k .. (s + 1) k``
(``k = (L - 1) / S``): it computes with them alone, its optimizer steps
them, the prologue and the epilogue, and holds the optimizer state of
those only. The other stages' blocks stay allocated in the model but are
not kept current: :meth:`PipelineLayout.gather_params` (a checkpoint,
``host_gather``) brings every block's parameters and running statistics
from its owner, and a checkpoint's optimizer state is gathered from the
owners into the one-device layout, as FSDP's is.

Schedule (GPipe, ``T = M + S - 1`` ticks; M microbatches, each a loader
batch of one bucket). The tick order, which the ranks must keep alike or
deadlock: at tick ``t`` stage ``s`` computes microbatch ``m = t - s`` when
``0 <= m < M`` (stage 0 on the prologue's output, the others on the
activation received at the end of tick ``t - 1``); then every stage enters
one exchange, posting in one ``batch_isend_irecv`` the send of its output to
stage ``s + 1`` (when it computed one and is not the last stage) and the
receive of its next input from stage ``s - 1`` (when ``0 <= t + 1 - s < M``
and it is not stage 0), and waits for both. The conditions are pure
functions of ``(t, s, M, S)``, so every send meets its receive in the same
exchange. The last stage's outputs are broadcast to every stage, which runs
the epilogue and the loss replicated.

Backward. ``_Ring``, an ``autograd.Function``, runs the reverse schedule in
its backward: ticks ``T - 1 .. 0``, stage ``s`` backpropagates microbatch
``t - s`` through the graph its forward recorded (the last stage from the
epilogue's cotangent, the others from the gradient received from ``s + 1``),
then one exchange sends the input's gradient to ``s - 1`` and receives the
next cotangent from ``s + 1``. Stage 0's input gradients flow into the
prologue. The JAX package derives this by differentiating ``scan`` and
``ppermute``; here it is written out. A stage's gradients of the blocks it
does not own are zero and not stepped; its own blocks' gradients are
whole; the prologue's (stage 0 alone backpropagates into it) are summed
over the stages in one all-reduce; the epilogue's are alike on every stage
already. So every stage steps the prologue and the epilogue alike, and
each block on its owner.

Norms (``norm``):

* ``"batch"`` (the train step's): every block normalises with its
  microbatch's statistics; the running statistics take one EMA step per
  microbatch from the same old values, averaged (the prologue's over the
  microbatches with real nodes, as the data-parallel step merges its
  replicas; a ring block's, on its owner, over the M microbatches);
* ``"running"`` (the eval step's): the running statistics, and the
  pipelined forward equals the sequential one bit for bit.

Refused as the JAX package refuses them (``validate_pipeline_support``):
GPS, stacks that read every layer's output, GAT with dropout (the
pipelined blocks run deterministically), fewer than ``S + 1`` conv layers,
and ``L - 1`` not divisible by S. ``Architecture.pipeline_microbatches``
sets M (default S). The pipelined steps run eager on the card (their
point-to-point exchanges are not captured).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..train.step import TrainState, freeze_conv_grads
from .comm import live, rank_of, send_recv, sum_tensors, world_of
from .step import Layout


def validate_pipeline_support(model, n_stage: int) -> int:
    """Blocks per stage ``k``; raises for what the pipeline does not run."""
    spec = model.spec
    n_layers = spec.num_conv_layers
    if spec.global_attn_engine:
        raise ValueError("pipeline parallelism does not compose with global attention engines "
                         "yet")
    if model.collect_layer_outputs:
        raise ValueError(f"{spec.mpnn_type} reads every layer's output (collect_layer_outputs) "
                         "— not pipelineable")
    if spec.mpnn_type == "GAT" and spec.dropout > 0:
        raise ValueError("pipelined execution is dropout-free (conv blocks run "
                         "deterministically); set Architecture.dropout to 0 for GAT under "
                         "pipeline parallelism")
    if n_layers < n_stage + 1:
        raise ValueError(f"{n_layers} conv layers cannot fill {n_stage} stages (block 0 is the "
                         "prologue; need num_conv_layers >= n_stage + 1)")
    if (n_layers - 1) % n_stage:
        raise ValueError(f"{n_layers - 1} pipelined layers not divisible by {n_stage} stages")
    shapes = [[tuple(p.shape) for p in _block_params(model, i)] for i in range(1, n_layers)]
    if any(s != shapes[0] for s in shapes[1:]):
        raise ValueError(f"conv blocks 1..L-1 are not parameter-homogeneous; got per-layer "
                         f"shapes {shapes}")
    return (n_layers - 1) // n_stage


def _block_params(model, i: int) -> list:
    ps = list(model.graph_convs[i].parameters())
    if len(model.feature_layers):
        ps += list(model.feature_layers[i].parameters())
    return ps


def _norm(model, i: int):
    return model.feature_layers[i] if len(model.feature_layers) else None


# the epilogue's modules: replicated on every stage, their gradients alike
_EPILOGUE = ("heads_NN", "graph_shared", "graph_pool_projector")


class Pipeline:
    """The schedule of one model over the default group's ranks (stages):
    ``n_micro`` microbatches, ``norm`` as the module says."""

    def __init__(self, model, n_micro: int | None = None, norm: str = "batch"):
        if norm not in ("batch", "running"):
            raise ValueError(f"norm must be 'batch' or 'running', got {norm!r}")
        self.model = model
        self.n_stage = world_of()
        self.stage = rank_of()
        self.k = validate_pipeline_support(model, self.n_stage)
        self.n_micro = int(n_micro or self.n_stage)
        if self.n_micro < 1:
            raise ValueError(f"pipeline_microbatches must be at least 1, got {self.n_micro}")
        self.norm = norm
        first = 1 + self.stage * self.k
        self.blocks = list(range(first, first + self.k))

    @property
    def ticks(self) -> int:
        return self.n_micro + self.n_stage - 1

    def _valid(self, t: int, s: int) -> bool:
        return 0 <= t - s < self.n_micro

    # -- the forward schedule (inside _Ring.forward) -------------------------
    def run_forward(self, inv0, eq0, batches, train: bool, grad_eq: bool):
        """Per microbatch ``(inputs, outputs)`` recorded on this stage, and
        the last stage's outputs (None elsewhere)."""
        S, s, M = self.n_stage, self.stage, self.n_micro
        model = self.model
        records: dict = {}
        outs_last = [None] * M
        held = None  # the activation received for the next tick
        stats = self._stats_begin(train)
        for t in range(self.ticks):
            m = t - s
            out = None
            if self._valid(t, s):
                if s == 0:
                    x, e = inv0[m].detach(), eq0[m].detach()
                else:
                    x, e = held
                if train:
                    x = x.requires_grad_(True)
                    if grad_eq:
                        e = e.requires_grad_(True)
                with torch.set_grad_enabled(train):
                    y, ye = x, e
                    for i in self.blocks:
                        self._stats_restore(stats, i)
                        y, ye = model.conv_block(i, y, ye, batches[m], self.norm == "batch")
                        self._stats_add(stats, i)
                records[m] = ((x, e), (y, ye))
                out = (y, ye)
                if s == S - 1:
                    outs_last[m] = out
            sends, recvs, held = [], [], None
            if out is not None and s < S - 1:
                sends = [(out[0].detach(), s + 1), (out[1].detach(), s + 1)]
            if s > 0 and self._valid(t + 1, s):
                held = (torch.empty_like(inv0[0]), torch.empty_like(eq0[0]))
                recvs = [(held[0], s - 1), (held[1], s - 1)]
            send_recv(sends, recvs)
        self._stats_end(stats)
        return records, outs_last

    def run_backward(self, records, g_inv, g_eq, grad_eq: bool):
        """The reverse schedule; returns stage 0's input gradients per
        microbatch (None elsewhere)."""
        S, s, M = self.n_stage, self.stage, self.n_micro
        d_in = [None] * M
        held = None  # the cotangent received for the next (earlier) tick
        for t in reversed(range(self.ticks)):
            m = t - s
            grad_in = None
            if self._valid(t, s):
                (x, e), (y, ye) = records.pop(m)
                gy, gye = (g_inv[m], g_eq[m]) if s == S - 1 else held
                outs, grads = [y], [gy]
                if grad_eq and ye.requires_grad:
                    outs.append(ye)
                    grads.append(gye)
                torch.autograd.backward(outs, grads)
                gx = x.grad if x.grad is not None else torch.zeros_like(x)
                ge = e.grad if grad_eq and e.grad is not None else torch.zeros_like(e)
                grad_in = (gx, ge)
                if s == 0:
                    d_in[m] = grad_in
            sends, recvs, held = [], [], None
            if grad_in is not None and s > 0:
                sends = [(grad_in[0], s - 1), (grad_in[1], s - 1)]
            if s < S - 1 and self._valid(t - 1, s):
                held = (torch.empty_like(g_inv[0]), torch.empty_like(g_eq[0]))
                recvs = [(held[0], s + 1), (held[1], s + 1)]
            send_recv(sends, recvs)
        return d_in

    # -- the ring blocks' running statistics ---------------------------------
    def _stats_begin(self, train: bool):
        """Under ``norm="batch"`` in a train forward: the owned norms' old
        statistics and the accumulators of their EMA-stepped values."""
        if not (train and self.norm == "batch"):
            return None
        out = {}
        for i in self.blocks:
            norm = _norm(self.model, i)
            if norm is not None:
                out[i] = ((norm.mean.clone(), norm.var.clone()),
                          [torch.zeros_like(norm.mean), torch.zeros_like(norm.var)])
        return out

    def _stats_restore(self, stats, i: int) -> None:
        if stats and i in stats:
            norm = _norm(self.model, i)
            with torch.no_grad():
                norm.mean.copy_(stats[i][0][0])
                norm.var.copy_(stats[i][0][1])

    def _stats_add(self, stats, i: int) -> None:
        if stats and i in stats:
            norm = _norm(self.model, i)
            with torch.no_grad():
                stats[i][1][0].add_(norm.mean)
                stats[i][1][1].add_(norm.var)

    def _stats_end(self, stats) -> None:
        if stats:
            with torch.no_grad():
                for i, (_, (acc_m, acc_v)) in stats.items():
                    norm = _norm(self.model, i)
                    norm.mean.copy_(acc_m / self.n_micro)
                    norm.var.copy_(acc_v / self.n_micro)


class _Ring(torch.autograd.Function):
    """The pipelined blocks ``1..L-1`` over the microbatches: the forward
    schedule forward, the reverse schedule backward (module docstring).
    Inputs: the prologue's ``inv`` and ``equiv`` per microbatch, flat;
    outputs: the stacked ``[M, ...]`` outputs of the last block on every
    stage."""

    @staticmethod
    def forward(ctx, pipe: Pipeline, batches, train: bool, grad_eq: bool, *flat):
        M = pipe.n_micro
        inv0, eq0 = list(flat[:M]), list(flat[M:])
        records, outs = pipe.run_forward(inv0, eq0, batches, train, grad_eq)
        last = pipe.n_stage - 1
        if pipe.stage == last:
            y_inv = torch.stack([o[0].detach() for o in outs])
            y_eq = torch.stack([o[1].detach() for o in outs])
        else:
            y_inv = inv0[0].new_empty((M,) + tuple(inv0[0].shape))
            y_eq = eq0[0].new_empty((M,) + tuple(eq0[0].shape))
        if live() and pipe.n_stage > 1:
            dist.broadcast(y_inv, last)
            dist.broadcast(y_eq, last)
        ctx.pipe, ctx.records, ctx.grad_eq, ctx.M = pipe, records, grad_eq, M
        if not grad_eq:
            ctx.mark_non_differentiable(y_eq)
        ctx.shapes = ((y_inv.shape, y_inv.dtype, y_inv.device),
                      (y_eq.shape, y_eq.dtype, y_eq.device))
        return y_inv, y_eq

    @staticmethod
    def backward(ctx, g_inv, g_eq):
        pipe = ctx.pipe
        (si, di, dvi), (se, de, dve) = ctx.shapes
        g_inv = torch.zeros(si, dtype=di, device=dvi) if g_inv is None else g_inv.contiguous()
        g_eq = torch.zeros(se, dtype=de, device=dve) if g_eq is None else g_eq.contiguous()
        d_in = pipe.run_backward(ctx.records, g_inv, g_eq, ctx.grad_eq)
        ctx.records = None
        M = ctx.M
        if pipe.stage != 0:
            return (None, None, None, None) + (None,) * (2 * M)
        return (None, None, None, None) + tuple(d[0] for d in d_in) + tuple(
            d[1] if ctx.grad_eq else None for d in d_in)


def _prologue(model, batches, train: bool):
    """Embedding and block 0 of every microbatch (replicated on every
    stage); in a train forward each microbatch's EMA step from the same old
    statistics, merged over the microbatches with real nodes."""
    norm = _norm(model, 0)
    old = (norm.mean.clone(), norm.var.clone()) if norm is not None and train else None
    acc = [torch.zeros_like(t) for t in old] if old else None
    reals = 0.0
    inv0, eq0 = [], []
    for b in batches:
        if old:
            with torch.no_grad():
                norm.mean.copy_(old[0])
                norm.var.copy_(old[1])
        inv, eq = model.embed(b)
        inv, eq = model.conv_block(0, inv, eq, b, train)
        inv0.append(inv)
        eq0.append(eq)
        if old:
            real = (b.node_mask.sum() > 0).to(torch.float32)
            with torch.no_grad():
                acc[0].add_(norm.mean * real)
                acc[1].add_(norm.var * real)
            reals = reals + real
    if old:
        with torch.no_grad():
            total = torch.clamp(torch.as_tensor(reals, dtype=torch.float32), min=1.0)
            norm.mean.copy_(acc[0] / total)
            norm.var.copy_(acc[1] / total)
    return inv0, eq0


class _Apply(torch.nn.Module):
    """Runs ``fn(model, *args)`` under ``functional_call`` (the cast
    parameters in place of the masters)."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, fn, *args):
        return fn(self.model, *args)


def _cast_call(model, compute_dtype, fn, *args):
    params = {f"model.{n}": (p.to(compute_dtype) if p.is_floating_point() else p)
              for n, p in model.named_parameters()}
    buffers = {f"model.{n}": b for n, b in model.named_buffers()}
    return torch.func.functional_call(_Apply(model), {**params, **buffers}, (fn, *args))


def pipelined_forward(pipe: Pipeline, batches, compute_dtype=torch.float32, train: bool = True):
    """Per-microbatch fp32 predictions of the pipelined model (``batches``:
    the M microbatches, uncast), the parameters and the batches' floating
    fields cast to ``compute_dtype`` as ``train/step.py::cast_forward``
    casts them. ``train``: a differentiable forward with the norms as
    ``pipe.norm`` says; else an eval forward (running statistics)."""
    if len(batches) != pipe.n_micro:
        raise ValueError(f"stacked microbatch has leading dim {len(batches)}, expected "
                         f"n_micro={pipe.n_micro}")
    c_batches = [b.map_floats(lambda t: t.to(compute_dtype)) for b in batches]
    batch_train = train and pipe.norm == "batch"

    def run(model, c_batches):
        inv0, eq0 = _prologue(model, c_batches, batch_train)
        grad_eq = train and eq0[0].requires_grad
        y_inv, y_eq = _Ring.apply(pipe, c_batches, train, grad_eq, *inv0, *eq0)
        preds = []
        for m, b in enumerate(c_batches):
            out = model.decode(y_inv[m], y_eq[m], b, False)
            if model.spec.var_output:
                means, variances = out
                preds.append(([o.to(torch.float32) for o in means],
                              [v.to(torch.float32) for v in variances]))
            else:
                preds.append([o.to(torch.float32) for o in out])
        return preds

    with torch.set_grad_enabled(train):
        return _cast_call(pipe.model, compute_dtype, run, c_batches)


def make_pipelined_train_step(model, compute_dtype=torch.float32, n_micro: int | None = None,
                              norm: str = "batch", loss_scale: float | None = None):
    """``(state, microbatches) -> metrics``: one pipelined step over the M
    microbatches (a tuple of batches of one bucket); the loss is their
    graph-count-weighted mean, as the data-parallel step's."""
    pipe = Pipeline(model, n_micro, norm)
    loss_scale = None if not loss_scale or float(loss_scale) == 1.0 else float(loss_scale)

    def train_step(state: TrainState, batches) -> dict:
        optimizer = state.optimizer
        preds = pipelined_forward(pipe, list(batches), compute_dtype, train=True)
        ngs = [b.graph_mask.sum() for b in batches]
        denom = torch.clamp(torch.stack(ngs).sum(), min=1.0)
        tots, tasks = [], []
        for pred, b, ng in zip(preds, batches, ngs):
            tot, task = model.loss(pred, b)
            # each microbatch weighted by its graphs' share (one microbatch:
            # weight 1, the one-device step's loss and gradients)
            w = ng / denom
            tots.append(tot * w)
            tasks.append(torch.stack(task) * w)
        loss = torch.stack(tots).sum()
        optimizer.zero_grad()
        (loss * loss_scale if loss_scale is not None else loss).backward()
        params = list(model.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif loss_scale is not None:
                p.grad.div_(loss_scale)
        if state.layout is not None:
            state.layout.reduce_grads(params)
        freeze_conv_grads(model)
        optimizer.step()
        state.step += 1
        return {"loss": loss.detach(), "tasks_loss": torch.stack(tasks).sum(0).detach(),
                "num_graphs": torch.stack(ngs).sum()}

    train_step.pipeline = pipe
    return train_step


def make_pipelined_eval_step(model, compute_dtype=torch.float32, n_micro: int | None = None,
                             norm: str = "running"):
    """``(state, microbatches) -> metrics``: the data-parallel eval step's
    metrics over the M microbatches, pipelined."""
    pipe = Pipeline(model, n_micro, norm)

    def eval_step(state: TrainState, batches) -> dict:
        preds = pipelined_forward(pipe, list(batches), compute_dtype, train=False)
        tots, tasks, sses, counts, ngs = [], [], [], [], []
        for pred, b in zip(preds, batches):
            tot, task = model.loss(pred, b)
            sse, count = model.head_sse(pred, b)
            ng = b.graph_mask.sum()
            tots.append(tot * ng)
            tasks.append(torch.stack(task) * ng)
            sses.append(torch.stack(sse))
            counts.append(torch.stack(count))
            ngs.append(ng)
        denom = torch.clamp(torch.stack(ngs).sum(), min=1.0)
        return {"loss": torch.stack(tots).sum() / denom,
                "tasks_loss": torch.stack(tasks).sum(0) / denom,
                "head_sse": torch.stack(sses).sum(0), "head_count": torch.stack(counts).sum(0),
                "num_graphs": torch.stack(ngs).sum()}

    return eval_step


@dataclasses.dataclass
class PipelineLayout(Layout):
    """The pipeline's layout over the default group (the module docstring):
    ``held``, the positions in ``model.parameters()`` of what this stage's
    optimizer steps (the prologue, its own blocks, the epilogue), in order;
    ``owner``, the stage of every block parameter's position; ``prologue``,
    the prologue parameters' positions; ``norms``, ``(norm, owner)`` of
    every block's feature norm."""

    model: torch.nn.Module | None = None
    held: list = dataclasses.field(default_factory=list)
    owner: dict = dataclasses.field(default_factory=dict)
    prologue: list = dataclasses.field(default_factory=list)
    norms: list = dataclasses.field(default_factory=list)

    def reduce_grads(self, params) -> None:
        """The prologue's gradients summed over the stages (stage 0's, the
        others' zeros); a block's are whole on its owner, the epilogue's
        alike on every stage."""
        sum_tensors([params[i].grad for i in self.prologue])

    def gather_params(self) -> None:
        """Every block's parameters and running statistics from its owner,
        one broadcast per stage."""
        if not live() or self.world == 1:
            return
        params = list(self.model.parameters())
        with torch.no_grad():
            for s in range(self.world):
                ts = ([params[i] for i, o in sorted(self.owner.items()) if o == s]
                      + [t for n, o in self.norms if o == s for t in (n.mean, n.var)])
                if not ts:
                    continue
                flat = torch.cat([t.detach().reshape(-1).float() for t in ts])
                dist.broadcast(flat, s)
                if s != self.rank:
                    for t, v in zip(ts, flat.split([t.numel() for t in ts])):
                        t.copy_(v.view_as(t))

    def full_optimizer_state(self, optimizer) -> dict:
        """The one-device layout's optimizer state dict: the entries of the
        parameters this stage holds by their position in the model, every
        block's from its owner (all-gathered). Every stage must call this."""
        sd = optimizer.state_dict()
        state = {self.held[i]: v for i, v in sd["state"].items()}
        if live() and self.world > 1:
            mine = {pos: {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in st.items()}
                    for pos, st in state.items() if self.owner.get(pos) == self.rank}
            every = [None] * self.world
            dist.all_gather_object(every, mine)
            for r, theirs in enumerate(every):
                if r != self.rank:
                    state.update(theirs)
        (group,) = sd["param_groups"]
        n = len(list(self.model.parameters()))
        return {"state": dict(sorted(state.items())),
                "param_groups": [{**group, "params": list(range(n))}]}

    def shard_optimizer_state(self, full: dict, optimizer) -> dict:
        """A one-device layout's optimizer state dict cut to what this
        stage's optimizer holds, in its order."""
        (group,) = full["param_groups"]
        return {"state": {i: full["state"][pos] for i, pos in enumerate(self.held)
                          if pos in full["state"]},
                "param_groups": [{**group, "params": list(range(len(self.held)))}]}

    def place_loaded(self, optimizer, full: dict) -> None:
        from ..train.optimizer import load_optimizer_state

        load_optimizer_state(optimizer, self.shard_optimizer_state(full, optimizer))


def place_pipeline(state: TrainState, optimizer_config: dict) -> TrainState:
    """Every stage's parameters and buffers made rank 0's, and the
    :class:`PipelineLayout`: the optimizer rebuilt (``Training.Optimizer``)
    over what this stage steps, its state (a resumed run's) cut from the
    one-device optimizer's. Returns the state (its ``layout`` set)."""
    from ..train.optimizer import load_optimizer_state, select_optimizer

    model = state.model
    if live():
        with torch.no_grad():
            for t in list(model.parameters()) + list(model.buffers()):
                dist.broadcast(t.data, 0)
    n_stage, stage = world_of(), rank_of()
    k = validate_pipeline_support(model, n_stage)
    pos = {id(p): i for i, p in enumerate(model.parameters())}
    layout = PipelineLayout(mode="pipeline", model=model)
    for i in range(1, model.spec.num_conv_layers):
        owner = (i - 1) // k
        layout.owner.update({pos[id(p)]: owner for p in _block_params(model, i)})
        if _norm(model, i) is not None:
            layout.norms.append((_norm(model, i), owner))
    epilogue = {id(p) for name in _EPILOGUE if getattr(model, name, None) is not None
                for p in getattr(model, name).parameters()}
    params = list(model.parameters())
    layout.prologue = [i for i, p in enumerate(params)
                       if i not in layout.owner and id(p) not in epilogue]
    layout.held = [i for i in range(len(params)) if layout.owner.get(i, stage) == stage]
    full = state.optimizer.state_dict()
    state.optimizer = select_optimizer(optimizer_config, [params[i] for i in layout.held])
    load_optimizer_state(state.optimizer, layout.shard_optimizer_state(full, state.optimizer))
    state.layout = layout
    return state


__all__ = ["Pipeline", "PipelineLayout", "make_pipelined_eval_step",
           "make_pipelined_train_step", "pipelined_forward", "place_pipeline",
           "validate_pipeline_support"]
