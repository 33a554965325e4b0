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
import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture
def joined_threads():
    """Every thread a test starts is finished when it ends (joined with a
    timeout, then asserted): under ``--dist loadfile`` a JAX test on the
    same worker counts leaked threads."""
    import threading

    before = set(threading.enumerate())
    yield
    # a RoundTripper's watchdog monitor (resilience/watchdog.py) is a daemon
    # that parks for the life of the process
    left = [t for t in threading.enumerate()
            if t not in before and t.name != "hydragnn-watchdog"]
    for t in left:
        t.join(timeout=10.0)
    alive = [t.name for t in left if t.is_alive()]
    assert not alive, alive


@pytest.fixture
def port_telemetry():
    """The port's telemetry plane, isolated (``telemetry.isolate``: a fresh
    registry, trace buffer, tracer timers, ledger, journal and context, and
    the config overrides put back after); yields the package. The port's
    counterpart of ``tests/conftest.py``'s ``telemetry_isolate``."""
    import hydragnn_tpu_torch.telemetry as tel

    with tel.isolate():
        yield tel

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


def assert_samples_equal(got, want, what: str = ""):
    """Two ``GraphSample`` sequences (either package's) equal field by field:
    every array bit-equal with its dtype, the scalars, and the extras (the
    readers' ``node_table`` / ``graph_table``) key by key."""
    from hydragnn_tpu_torch.graphs.graph import GraphSample

    got, want = list(got), list(want)
    assert len(got) == len(want), f"{what}: {len(got)} samples, want {len(want)}"
    for i, (a, b) in enumerate(zip(got, want)):
        for f in GraphSample.__slots__:
            u, v = getattr(a, f), getattr(b, f)
            if f == "extras":
                assert sorted(u) == sorted(v), f"{what}[{i}] extras {sorted(u)} {sorted(v)}"
                for k in u:
                    x, y = np.asarray(u[k]), np.asarray(v[k])
                    assert x.dtype == y.dtype and np.array_equal(x, y), f"{what}[{i}] {k}"
            elif isinstance(u, np.ndarray) or isinstance(v, np.ndarray):
                assert isinstance(u, np.ndarray) and isinstance(v, np.ndarray), f"{what}[{i}] {f}"
                assert u.dtype == v.dtype and np.array_equal(u, v), f"{what}[{i}] {f}"
            else:
                assert u == v, f"{what}[{i}] {f}: {u} != {v}"


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


def flax_variables_from_port(port_model, jmodel, jbatch, jitter_seed: int | None = None):
    """The JAX model's ``{"params", "batch_stats"}`` holding the port model's
    values: the flax tree's structure from ``jax.eval_shape`` of the JAX
    init (no compile), each leaf from the port's state dict by
    ``convert``'s name map (kernels transposed). With ``jitter_seed``,
    every parameter moved by a seeded ``N(0, 0.05)`` and the running
    statistics drawn as :func:`random_batch_stats` draws them."""
    import jax
    import jax.numpy as jnp

    from hydragnn_tpu_torch.convert import _port_name

    shapes = jax.eval_shape(lambda b: jmodel.init(jax.random.PRNGKey(0), b),
                            jax.tree.map(jnp.asarray, jbatch))
    state = {k: v.detach().cpu().numpy() for k, v in port_model.state_dict().items()}
    rng = np.random.default_rng(jitter_seed)

    def fill(path, leaf):
        keys = tuple(p.key for p in path)
        a = state[_port_name(keys[1:])]
        a = np.array(a.T if keys[-1] == "kernel" else a, np.float32)
        assert a.shape == tuple(leaf.shape), (keys, a.shape, leaf.shape)
        if jitter_seed is not None:
            if keys[0] == "params":
                a = a + rng.normal(scale=0.05, size=a.shape).astype(np.float32)
            elif keys[-1] == "mean":
                a = rng.normal(scale=0.1, size=a.shape).astype(np.float32)
            else:
                a = rng.uniform(0.5, 2.0, size=a.shape).astype(np.float32)
        return a

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return {"params": numpy_tree(tree["params"]),
            "batch_stats": numpy_tree(tree.get("batch_stats", {}))}


def performer_projections(jmodel, jbatch, variables, dtype):
    """The GPS performer's fixed projections as the JAX package draws them
    in a forward at ``dtype``: ``{"graph_convs_{i}/attn": w}``, each drawn
    from the key of its module path at the dtype of that layer's features
    (recorded from an abstract trace of the forward)."""
    import zlib

    import jax
    import jax.numpy as jnp

    from hydragnn_tpu.train.step import _cast_floats

    drawn = []
    real_normal = jax.random.normal

    def spy(key, shape=(), dtype=jnp.float32):
        drawn.append((tuple(shape), jnp.dtype(dtype)))
        return real_normal(key, shape, dtype)

    jax.random.normal = spy
    try:
        jax.eval_shape(lambda p, b: jmodel.apply(
            {"params": _cast_floats(p, dtype), "batch_stats": variables["batch_stats"]},
            _cast_floats(b, dtype)), variables["params"], jax.tree.map(jnp.asarray, jbatch))
    finally:
        jax.random.normal = real_normal
    out = {}
    for i, (shape, dt) in enumerate(drawn):
        path = f"graph_convs_{i}/attn"
        seed = zlib.crc32(path.encode()) & 0x7FFFFFFF
        out[path] = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, dt),
                               np.float32)
    return out


def jax_reference(jmodel, variables, jbatch, dtype, eval_outputs: bool = True):
    """One jitted JAX evaluation at ``dtype`` (the steps' casts): the
    train-mode outputs, loss, per-task losses, parameter gradients (port
    names) and updated running statistics (port names), and with
    ``eval_outputs`` the eval-mode outputs (``outputs``)."""
    import jax
    import jax.numpy as jnp

    from hydragnn_tpu.train.step import _cast_floats
    from hydragnn_tpu_torch.convert import port_arrays

    def both(params, stats, b):
        out = (jmodel.apply({"params": _cast_floats(params, dtype), "batch_stats": stats},
                            _cast_floats(b, dtype)) if eval_outputs else [])

        def loss_fn(p):
            o, upd = jmodel.apply({"params": _cast_floats(p, dtype), "batch_stats": stats},
                                  _cast_floats(b, dtype), train=True, mutable=["batch_stats"])
            o = _cast_floats(o, jnp.float32)
            tot, tasks = jmodel.loss(o, b)
            return tot, (o, jnp.stack(tasks), upd["batch_stats"])

        (tot, (train_out, tasks, upd)), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return _cast_floats(out, jnp.float32), train_out, tot, tasks, g, upd

    out, train_out, tot, tasks, grads, stats = jax.jit(both)(
        variables["params"], variables["batch_stats"], jax.tree.map(jnp.asarray, jbatch))
    # a var_output model's (means, variances): the means, then the variances
    return {"outputs": [np.asarray(o) for o in jax.tree.leaves(out)],
            "train_outputs": [np.asarray(o) for o in jax.tree.leaves(train_out)],
            "loss": float(tot),
            "tasks": np.asarray(tasks), "grads": port_arrays(numpy_tree(grads)),
            "stats": port_arrays(numpy_tree(stats))}


def flat_outputs(out) -> list:
    """Per-head outputs as one list: a ``var_output`` model's ``(means,
    variances)`` as the means, then the variances."""
    if isinstance(out, tuple):
        return [*out[0], *out[1]]
    return list(out)


def port_reference(model, jbatch, dtype):
    """The port's counterpart of :func:`jax_reference` on the same batch:
    eval-mode outputs, then the train-mode outputs, loss, per-task losses,
    gradients and running statistics (``model``'s are updated in place)."""
    from hydragnn_tpu_torch.convert import batch_from_numpy
    from hydragnn_tpu_torch.train.step import cast_forward, make_predict_step

    out = [o.numpy() for o in flat_outputs(make_predict_step(model, dtype)(
        batch_from_numpy(jbatch)))]
    # a fresh batch: the predict step's cached layouts are inference tensors
    pb = batch_from_numpy(jbatch)
    model.zero_grad()
    pred = cast_forward(model, pb, dtype, train=True)
    tot, tasks = model.loss(pred, pb)
    tot.backward()
    return {"outputs": out,
            "train_outputs": [o.detach().numpy() for o in flat_outputs(pred)],
            "loss": float(tot.detach()),
            "tasks": torch.stack(tasks).detach().numpy(),
            "grads": {n: (p.grad.numpy() if p.grad is not None else np.zeros(tuple(p.shape),
                                                                            np.float32))
                      for n, p in model.named_parameters()},
            "stats": {n: b.numpy() for n, b in model.state_dict().items()}}


def real_rows(outputs, jbatch, spec):
    """Per head, the rows of real graphs or nodes."""
    gm = np.asarray(jbatch.graph_mask) > 0
    nm = np.asarray(jbatch.node_mask) > 0
    return [np.asarray(o, np.float32)[gm if kind == "graph" else nm]
            for o, kind in zip(outputs, spec.output_type)]


def gloo_normalise_worker(rank, world, port, maxima, out):
    """One process of a ``gloo`` group: a one-edge sample whose length is
    ``maxima[rank]`` through ``normalize_edge_lengths_global``; puts
    ``(rank, divisor, normalised length)`` on ``out``. Lives here, not in a
    test module, so that the spawned process imports no JAX."""
    import torch.distributed as dist

    from hydragnn_tpu_torch.graphs.graph import GraphSample
    from hydragnn_tpu_torch.preprocess.transforms import normalize_edge_lengths_global

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        s = GraphSample(x=np.zeros((2, 1)), senders=[0], receivers=[1],
                        edge_attr=[[maxima[rank]]])
        out.put((rank, normalize_edge_lengths_global([s]), float(s.edge_attr[0, 0])))
    finally:
        dist.destroy_process_group()


__all__ = [
    "assert_within_jax_bf16_gap",
    "flax_variables_from_port",
    "gloo_normalise_worker",
    "jax_reference",
    "jax_samples_copy",
    "jitter_params",
    "numpy_tree",
    "performer_projections",
    "port_model_from_jax",
    "port_reference",
    "port_samples",
    "random_batch_stats",
    "real_rows",
]


class PairSetup:
    """One configuration in both packages on copies of the same JAX
    ``samples``: each package's loaders, augmented config and model, the
    shared variables (the port's draw, jittered, written into the JAX
    model's tree by :func:`flax_variables_from_port`; running statistics
    drawn) and the JAX loader's first train batch. :meth:`port_model`
    carries the variables into a fresh port model with
    ``convert.load_jax_variables``; :meth:`jax` and :meth:`port` give each
    package's reference (:func:`jax_reference`, :func:`port_reference`) at
    ``"fp32"`` or ``"bf16"``, once each. ``raw_batch``: the samples are
    used as they are (no loading pass, every sample a training one) and the
    batch is the first ``raw_batch`` of them, collated by the JAX package.
    """

    DTYPES = {"fp32": ("float32", torch.float32), "bf16": ("bfloat16", torch.bfloat16)}

    def __init__(self, cfg: dict, samples, jitter_seed: int = 1, raw_batch: int = 0):
        from hydragnn_tpu.config import update_config as jax_update_config
        from hydragnn_tpu.graphs.batching import collate as jax_collate
        from hydragnn_tpu.graphs.batching import compute_pad_spec as jax_pad_spec
        from hydragnn_tpu.models import create_model_config as jax_create_model_config
        from hydragnn_tpu.preprocess.load_data import dataset_loading_and_splitting as jl
        from hydragnn_tpu_torch.config import update_config
        from hydragnn_tpu_torch.models import create_model_config
        from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting

        self.cfg = cfg
        if raw_batch:
            jtrain, train = jax_samples_copy(samples), port_samples(samples)
            self.jaug = jax_update_config(copy.deepcopy(cfg), jtrain)
            self.aug = update_config(copy.deepcopy(cfg), train)
            self.batch = jax_collate(jtrain[:raw_batch], jax_pad_spec(jtrain, raw_batch))
        else:
            self.jloaders = jl(copy.deepcopy(cfg), samples=jax_samples_copy(samples))
            self.loaders = dataset_loading_and_splitting(copy.deepcopy(cfg),
                                                         samples=port_samples(samples))
            self.jaug = jax_update_config(copy.deepcopy(cfg),
                                          *(ld.samples for ld in self.jloaders))
            self.aug = update_config(copy.deepcopy(cfg), *(ld.samples for ld in self.loaders))
            self.batch = next(iter(self.jloaders[0]))
        self.jmodel = jax_create_model_config(self.jaug)
        first = create_model_config(copy.deepcopy(self.aug), device="cpu", seed=0)
        self.spec = first.spec
        self.variables = flax_variables_from_port(first, self.jmodel, self.batch,
                                                  jitter_seed=jitter_seed)
        self._refs: dict = {}

    def port_model(self):
        from hydragnn_tpu_torch.convert import load_jax_variables
        from hydragnn_tpu_torch.models import create_model_config

        model = create_model_config(copy.deepcopy(self.aug), device="cpu", seed=1)
        return load_jax_variables(model, self.variables["params"], self.variables["batch_stats"])

    def jax(self, precision: str = "fp32") -> dict:
        import jax.numpy as jnp

        key = ("jax", precision)
        if key not in self._refs:
            self._refs[key] = jax_reference(self.jmodel, self.variables, self.batch,
                                            jnp.dtype(self.DTYPES[precision][0]))
        return self._refs[key]

    def port(self, precision: str = "fp32") -> dict:
        key = ("port", precision)
        if key not in self._refs:
            self._refs[key] = port_reference(self.port_model(), self.batch,
                                             self.DTYPES[precision][1])
        return self._refs[key]

    def head_rows(self, outputs) -> list:
        """Per flattened output (the means, then any variances), its real
        rows."""
        kinds = list(self.spec.output_type) * (2 if self.spec.var_output else 1)
        gm = np.asarray(self.batch.graph_mask) > 0
        nm = np.asarray(self.batch.node_mask) > 0
        assert len(outputs) == len(kinds)
        return [np.asarray(o, np.float32)[gm if k == "graph" else nm]
                for o, k in zip(outputs, kinds)]

    def assert_matches(self, precision: str = "fp32", fwd=None, grad=None, what: str = "",
                       grad_scale: float = 0.0):
        """Eval and train outputs on real rows, loss, per-task losses and
        every parameter gradient, port against JAX, at ``fwd`` and
        ``grad`` (``np.testing.assert_allclose`` keyword dicts); the
        gradients' ``atol`` grows by ``grad_scale`` times the model's
        largest JAX gradient (a gradient that cancels, such as a bias's in
        front of a batch norm, carries the rounding of the largest
        terms)."""
        want, got = self.jax(precision), self.port(precision)
        g_max = max(float(np.abs(w).max()) for w in want["grads"].values() if w.size)
        grad = dict(grad, atol=grad["atol"] + grad_scale * g_max)
        for key in ("outputs", "train_outputs"):
            for i, (g, w) in enumerate(zip(self.head_rows(got[key]),
                                           self.head_rows(want[key]))):
                np.testing.assert_allclose(g, w, **fwd, err_msg=f"{what} {key}[{i}]")
        np.testing.assert_allclose(got["loss"], want["loss"], **fwd, err_msg=f"{what} loss")
        np.testing.assert_allclose(got["tasks"], want["tasks"], **fwd, err_msg=f"{what} tasks")
        assert set(got["grads"]) == set(want["grads"]), what
        for name, w in want["grads"].items():
            np.testing.assert_allclose(got["grads"][name], w, **grad,
                                       err_msg=f"{what} gradient {name}")
        for name, w in want["stats"].items():
            np.testing.assert_allclose(got["stats"][name], w, **fwd, err_msg=f"{what} {name}")
