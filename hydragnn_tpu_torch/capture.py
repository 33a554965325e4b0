"""CUDA graphs: the port's device-resident dispatch.

Counterpart of the JAX package's ahead-of-time executables
(``hydragnn_tpu/utils/compile_cache.py::aot_compile``), its supersteps'
dispatch (``train/superstep.py``) and its MD ``lax.scan``, and of its
zero-recompile sentinel (``hydragnn_tpu/analysis/sentinel.py::no_recompile``).
Where the JAX package compiles one program per (path, bucket), the port
captures the eager step once per (path, bucket) into a CUDA graph and
replays it: a step of 600-2,300 small device operations becomes one launch
from the host.

A :class:`StepGraphs` holds the graphs of one step function
``fn(state, batch) -> outputs``:

* the key is the batch's signature: every field's shape and dtype (the
  bucket), the per-graph node bound of its meta and its sortedness
  certificates;
* a capture copies the first batch into static input slots, runs the step
  :data:`WARMUP` times on a side stream (which builds the kernels and sets
  up cuBLAS, autograd and the optimizer's state), puts back everything
  those runs changed (:func:`preserved`), and captures one run on a side
  stream; the kernel launches on that stream, from any thread (autograd
  runs backwards on its own), are the graph's record;
* :meth:`StepGraphs.run` copies the batch's fields into the slots with
  ``copy_``, replays, adds the record to ``ops.fused_scatter.LAUNCHES`` and
  returns clones of the static outputs, which the next replay overwrites.

The slots keep the batch's meta: the CSR views skip the argsort of the ids
it certifies sorted, as the eager step does. A batch of a bucket whose
graph certifies less (sorts ids the batch certifies sorted) replays that
graph: a stable argsort leaves sorted ids in place, so it sums in the eager
step's order. Each run hands the step a fresh ``GraphBatch`` over the slots
(an empty CSR cache), so the views are built inside the captured region,
never taken from a warm-up's cache.

:class:`SegmentGraph` captures ``n`` applications of an MD step to a state
of tensors (``md.run_md``'s trajectory segment).

Callers capture for CUDA tensors and run the eager step for CPU tensors,
as the kernels route; a capture that fails raises. A graph holds the
addresses of the state it was captured against: :meth:`StepGraphs.run`
refuses another state object.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import threading

import torch

from .graphs.graph import FIELDS, GraphBatch
from .ops import fused_scatter as fs

# eager runs of a step on a side stream before its capture
WARMUP = 2

_CAPTURE_LOCK = threading.Lock()  # one capture at a time in the process
_GUARD_LOCK = threading.Lock()
_GUARDS: list[str] = []  # guarded-by: _GUARD_LOCK
_TOTAL = {"captures": 0}  # guarded-by: _GUARD_LOCK


class NewCaptureError(RuntimeError):
    """A capture was asked for inside :func:`no_new_captures`."""


@contextlib.contextmanager
def no_new_captures(what: str):
    """Inside, any capture in the process raises :class:`NewCaptureError`
    naming ``what``: the port of ``no_recompile(0)``, proof that a pass
    replays graphs captured before it."""
    with _GUARD_LOCK:
        _GUARDS.append(what)
    try:
        yield
    finally:
        with _GUARD_LOCK:
            _GUARDS.remove(what)


def total_captures() -> int:
    """Graphs captured in this process."""
    with _GUARD_LOCK:
        return _TOTAL["captures"]


def _check_guards(describe: str) -> None:
    with _GUARD_LOCK:
        guards = list(_GUARDS)
    if guards:
        raise NewCaptureError(f"{guards[-1]}: a new capture was asked for ({describe})")


def _count_capture() -> None:
    with _GUARD_LOCK:
        _TOTAL["captures"] += 1


_CERTIFICATES = ("recv_sorted", "send_sorted", "batch_sorted", "ji_sorted")


def signature(batch: GraphBatch) -> tuple:
    """What a graph is specialised to: every field's shape and dtype, the
    per-graph node bound (GPS's dense attention width) and which id arrays
    the meta certifies sorted."""
    fields = tuple((tuple(getattr(batch, f).shape), getattr(batch, f).dtype) for f in FIELDS)
    meta = batch.meta
    if meta is None:
        return fields, None, (False,) * len(_CERTIFICATES)
    return fields, meta.max_n_node, tuple(bool(getattr(meta, c)) for c in _CERTIFICATES)


def _serves(graph_key: tuple, key: tuple) -> bool:
    """Whether the graph of ``graph_key`` answers a batch of ``key`` as its
    own graph would: same shapes and node bound, and every id array the
    graph takes as sorted certified sorted in the batch."""
    return graph_key[:2] == key[:2] and all(b or not g for g, b in zip(graph_key[2], key[2]))


def bucket_of(batch: GraphBatch) -> tuple[int, int, int, int]:
    """The batch's ``PadSpec.as_tuple()``."""
    return batch.num_nodes, batch.num_edges, batch.num_graphs, int(batch.idx_kj.shape[0])


def _static_copy(batch: GraphBatch, device) -> GraphBatch:
    return GraphBatch(**{f: getattr(batch, f).to(device, copy=True) for f in FIELDS},
                      meta=batch.meta)


def clone_tree(x):
    """Clones of the tensors of nested lists, tuples (named too) and
    dicts."""
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(clone_tree(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(clone_tree(v) for v in x)
    return x


@contextlib.contextmanager
def preserved(state):
    """Puts back, on exit, everything a train step changes in ``state`` (a
    ``TrainState``): parameters and buffers, the optimizer's state tensors
    (those created inside are zeroed: every optimizer of the port starts its
    state at zero), the host step count; inside, the steps draw from a
    throwaway generator, so the state's own does not advance. Ordered on the
    current stream: the caller makes it wait for work done elsewhere before
    the exit."""
    model, optimizer = state.model, state.optimizer
    tensors = list(itertools.chain(model.parameters(), model.buffers()))
    with torch.no_grad():
        saved = [t.detach().clone() for t in tensors]
        before = {id(p): {k: v.clone() for k, v in s.items() if torch.is_tensor(v)}
                  for p, s in optimizer.state.items()}
    step, generator = state.step, state.generator
    if generator is not None:
        state.generator = torch.Generator(device=generator.device).manual_seed(0)
    try:
        yield
    finally:
        state.step, state.generator = step, generator
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
            for p, s in optimizer.state.items():
                old = before.get(id(p), {})
                for k, v in s.items():
                    if torch.is_tensor(v) and k in old:
                        v.copy_(old[k])
                    elif torch.is_tensor(v):
                        v.zero_()


@dataclasses.dataclass
class Graph:
    """One captured graph: its static input slots, its static outputs, the
    kernel launches of one replay, and the batch the captured run saw (its
    CSR views, whose tickets are back at 0 after every replay)."""

    graph: "torch.cuda.CUDAGraph"
    slots: GraphBatch
    outputs: object
    launches: dict
    view: GraphBatch
    replays: int = 0


def _capture(warm, run, device, generator=None, before=contextlib.nullcontext):
    """``warm()`` :data:`WARMUP` times on a side stream inside ``before()``
    (which undoes their effects; their launches count nowhere), then
    ``run()`` captured; returns ``(graph, outputs of the captured run, its
    kernel launches)``. ``generator`` is registered with the graph: a
    replay draws what the eager step would, and advances it as that would."""
    cur = torch.cuda.current_stream(device)
    side, stream = torch.cuda.Stream(device), torch.cuda.Stream(device)
    side.wait_stream(cur)
    with before():
        with torch.cuda.stream(side), fs.launch_sink(side):
            for _ in range(WARMUP):
                warm()
        cur.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    # torch.cuda.graph collects garbage before it starts; a collection
    # during the capture could free an older graph, which a capture forbids
    gc_enabled = gc.isenabled()
    gc.disable()
    try:
        with fs.launch_sink(stream) as launches:
            with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                outputs = run()
    finally:
        if gc_enabled:
            gc.enable()
    _count_capture()
    return graph, outputs, dict(launches)


class StepGraphs:
    """The CUDA graphs of ``fn(state, batch) -> outputs``, one per batch
    signature, captured at first use. ``train``: ``fn`` is a train step,
    which changes ``state`` (a ``TrainState``): the warm-up's changes are
    undone, the state's dropout generator is registered with the graph, and
    every replay advances ``state.step``. ``name`` names the path in errors
    and reports; ``device``, when given, is the card the graphs run on, and
    the batches may then lie on the host (they are copied into the
    slots)."""

    def __init__(self, fn, name: str, train: bool = False, device=None):
        self.fn = fn
        self.name = name
        self.train = train
        self.device = None if device is None else torch.device(device)
        self.graphs: dict[tuple, Graph] = {}
        self.captures = 0
        self._state = None

    def capture(self, state, batch) -> Graph:
        """The graph that answers ``batch`` (captured now if none does)."""
        key = signature(batch)
        g = self.graphs.get(key)
        if g is None:
            g = next((g for k, g in self.graphs.items() if _serves(k, key)), None)
        if g is not None:
            return g
        device = self.device or batch.device
        if device.type != "cuda":
            raise ValueError(f"{self.name}: CUDA graphs run on the card, not on {device}")
        _check_guards(f"{self.name}, bucket {bucket_of(batch)}")
        if self._state is None:
            self._state = state
        with _CAPTURE_LOCK:
            slots = _static_copy(batch, device)
            view = slots.replace()
            step = state.step if self.train else None
            graph, outputs, launches = _capture(
                lambda: self.fn(state, slots.replace()), lambda: self.fn(state, view), device,
                generator=state.generator if self.train else None,
                before=(lambda: preserved(state)) if self.train else contextlib.nullcontext)
            if self.train:
                state.step = step
        g = Graph(graph=graph, slots=slots, outputs=outputs, launches=launches, view=view)
        self.graphs[key] = g
        self.captures += 1
        return g

    def run(self, state, batch):
        """``fn(state, batch)`` by a replay of its graph (captured first if
        new); returns clones of its outputs."""
        if self._state is not None and state is not self._state:
            raise ValueError(f"{self.name}: these graphs were captured against another state")
        g = self.capture(state, batch)
        with torch.no_grad():
            for f in FIELDS:
                getattr(g.slots, f).copy_(getattr(batch, f))
        g.graph.replay()
        g.replays += 1
        fs.add_launches(g.launches)
        if self.train:
            state.step += 1
        return clone_tree(g.outputs)

    def stats(self) -> dict:
        """Captures, the buckets of the graphs, and replays."""
        return {
            "captures": self.captures,
            "graphs": sorted(bucket_of(g.slots) for g in self.graphs.values()),
            "replays": sum(g.replays for g in self.graphs.values()),
        }


class Dispatch:
    """``step(state, batch)`` routed by device: on the card a replay of the
    step's graph for the batch's bucket, on the CPU the eager step itself;
    ``graphs`` holds the captures. ``train`` and ``device``: see
    :class:`StepGraphs` (without ``device`` the batch's own device
    routes)."""

    def __init__(self, step, name: str, train: bool = False, device=None):
        self.step = step
        self.graphs = StepGraphs(step, name, train=train, device=device)

    def __call__(self, state, batch):
        if (self.graphs.device or batch.device).type == "cuda":
            return self.graphs.run(state, batch)
        return self.step(state, batch)


class SegmentGraph:
    """``n`` applications of ``step`` to ``state`` (a tuple, named or not,
    of tensors) captured as one graph over a static copy of the state, which
    every replay advances in place: ``md.run_md``'s trajectory segment, as
    the JAX package's ``lax.scan`` rolls it. The warm-up runs on a copy."""

    def __init__(self, step, state, n: int, name: str = "segment"):
        device = state[0].device
        if device.type != "cuda":
            raise ValueError(f"{name}: CUDA graphs take a state on the card, got {device}")
        self.n = int(n)
        self.state = clone_tree(state)
        _check_guards(f"{name}, {self.n} steps")

        def segment(s):
            out = s
            for _ in range(self.n):
                out = step(out)
            with torch.no_grad():
                for dst, src in zip(s, out):
                    dst.copy_(src)

        scratch = clone_tree(state)
        with _CAPTURE_LOCK:
            self.graph, _, self.launches = _capture(lambda: segment(scratch),
                                                    lambda: segment(self.state), device)
        self.replays = 0

    def run(self):
        """One replay: ``n`` more steps; returns a clone of the state."""
        self.graph.replay()
        self.replays += 1
        fs.add_launches(self.launches)
        return clone_tree(self.state)


__all__ = [
    "Dispatch",
    "Graph",
    "NewCaptureError",
    "SegmentGraph",
    "StepGraphs",
    "WARMUP",
    "bucket_of",
    "clone_tree",
    "no_new_captures",
    "preserved",
    "signature",
    "total_captures",
]
