"""Supersteps and the host side of the port's CUDA-graph dispatch, on the
CPU (the graphs themselves run on the card: ``test_torch_capture_gpu.py``).

- the bucket-major plan of ``GraphLoader.set_superstep`` is the JAX
  loader's, index for index, leftover tail included;
- a K = 4 epoch through ``make_superstep`` equals the single steps over
  the same plan bit for bit in fp32, trailing partial block included, and
  its losses agree with the JAX package's K = 1 epoch over that plan
  (rtol 1e-4, the train-loss tolerance of ``test_torch_train_loop.py``);
- ``run_training`` takes ``steps_per_dispatch: 4`` and gives the losses of
  K = 1 over the same plan, exactly;
- ``PrefetchLoader.set_superstep`` and its one producer thread
  (``background_iter``, the port's ``double_buffer``);
- ``capture.preserved`` puts a train state back exactly, the CPU route
  captures nothing, a graph's key holds the batch's sortedness
  certificates, the optimizers' device learning rate and in-place state
  load;
- the dense MD build's static compaction gives ``torch.nonzero``'s edges.
"""

import copy

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as conftest pins it)
import numpy as np
import pytest
import torch

import torch_port_util as tpu
from hydragnn_tpu.graphs.batching import GraphLoader as JaxLoader
from hydragnn_tpu.graphs.graph import GraphSample as JaxSample
from hydragnn_tpu.preprocess.load_data import dataset_loading_and_splitting as jax_loading
from hydragnn_tpu.train.loop import train_epoch as jax_train_epoch
from hydragnn_tpu_torch import capture
from hydragnn_tpu_torch.config import update_config
from hydragnn_tpu_torch.datasets import deterministic_graph_data
from hydragnn_tpu_torch.graphs.batching import GraphLoader, PrefetchLoader, background_iter
from hydragnn_tpu_torch.models import create_model_config
from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting
from hydragnn_tpu_torch.train.loop import accumulate, train_epoch, train_validate_test
from hydragnn_tpu_torch.train.optimizer import (
    CapturableAdam,
    CapturableSGD,
    load_optimizer_state,
    select_optimizer,
    set_learning_rate,
)
from hydragnn_tpu_torch.train.step import TrainState, create_train_state, make_train_step
from hydragnn_tpu_torch.train.superstep import make_superstep, resolve_steps_per_dispatch
from test_torch_train_step import Setup, single_head_config


def _sized_samples(n: int, seed: int):
    """JAX samples of 3-40 nodes and up to 3 edges per node."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(3, 41))
        e = int(rng.integers(0, 3 * k + 1))
        out.append(JaxSample(x=rng.normal(size=(k, 1)).astype(np.float32),
                             senders=rng.integers(0, k, e), receivers=rng.integers(0, k, e),
                             graph_y=np.zeros(1, np.float32)))
    return out


def _plan(loader):
    return [(c.tolist(), p.as_tuple()) for c, p in loader.batch_plan()]


@pytest.mark.parametrize("k", [1, 2, 4])
def test_bucket_major_plan_equals_jax(k):
    jax_samples = _sized_samples(150, 3)
    ours = GraphLoader(tpu.port_samples(jax_samples), 8, shuffle=True, seed=5, buckets=4)
    theirs = JaxLoader(jax_samples, 8, shuffle=True, seed=5, buckets=4)
    assert [b.as_tuple() for b in ours.buckets] == [b.as_tuple() for b in theirs.buckets]
    assert len(ours.buckets) == 4
    ours.set_superstep(k)
    theirs.set_superstep(k)
    top = ours.buckets[-1].as_tuple()
    leftovers = 0
    for epoch in range(3):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got = _plan(ours)
        assert got == _plan(theirs)
        assert sorted(i for c, _ in got for i in c) == sorted(
            i for c, _ in ours.batch_plan() for i in c)
        # batches re-padded to the top bucket at the tail: the leftovers
        leftovers += sum(1 for c, p in ours.batch_plan()
                         if p.as_tuple() == top and ours._pick(c).as_tuple() != top)
        if k > 1:
            for i in range(0, len(got) - len(got) % k, k):
                assert len({p for _, p in got[i:i + k]}) == 1, "a block spans two buckets"
    assert len(got) == 18 and len(got) % 4 == 2  # 150 samples of 8: a partial last block
    assert (leftovers > 0) == (k > 1)


def _bucketed_config(k: int = 1, epochs: int = 2):
    cfg = single_head_config()
    training = cfg["NeuralNetwork"]["Training"]
    training.update(num_epoch=epochs, batch_size=8, pad_buckets=2, steps_per_dispatch=k)
    return cfg


def _fresh_port_state(cfg, samples, seed=0):
    loaders = dataset_loading_and_splitting(copy.deepcopy(cfg), samples=samples)
    aug = update_config(copy.deepcopy(cfg), *(ld.samples for ld in loaders))
    model = create_model_config(aug, device="cpu", seed=seed)
    return create_train_state(model, aug["NeuralNetwork"]["Training"]["Optimizer"], seed), \
        loaders, aug


def _assert_states_equal(a: TrainState, b: TrainState):
    for (name, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), name
    for (pa, sa), (pb, sb) in zip(a.optimizer.state.items(), b.optimizer.state.items()):
        for key in sa:
            assert torch.equal(torch.as_tensor(sa[key]), torch.as_tensor(sb[key])), key
    assert a.step == b.step


def test_superstep_epoch_equals_single_steps_with_a_partial_tail():
    samples = deterministic_graph_data(number_configurations=120, seed=7)
    cfg = _bucketed_config()
    blocked, loaders, _ = _fresh_port_state(cfg, samples)
    single, _, _ = _fresh_port_state(cfg, samples)
    train = loaders[0]
    train.set_superstep(4)
    train.set_epoch(1)
    assert len(train) % 4 != 0, "the epoch must end in a partial block"
    step = make_train_step()
    loss, tasks = train_epoch(make_superstep(step, 4), blocked, train)
    metrics = [step(single, b) for b in train]
    want_loss, want_tasks, _ = accumulate(metrics)
    assert loss == want_loss and np.array_equal(tasks, want_tasks)
    assert blocked.step == len(train)
    _assert_states_equal(blocked, single)


def test_superstep_epoch_matches_the_jax_k1_epoch_over_the_same_plan():
    cfg = _bucketed_config()
    setup = Setup(cfg, n_samples=96)
    jl = jax_loading(copy.deepcopy(cfg), samples=deterministic_graph_data(
        number_configurations=96, seed=7))
    pl = dataset_loading_and_splitting(copy.deepcopy(cfg), samples=tpu.port_samples(
        deterministic_graph_data(number_configurations=96, seed=7)))
    jl[0].set_superstep(4)
    pl[0].set_superstep(4)
    jl[0].set_epoch(0)
    pl[0].set_epoch(0)
    assert [c.tolist() for c, _ in jl[0].batch_plan()] == [c.tolist() for c, _ in
                                                           pl[0].batch_plan()]
    _, want, _ = jax_train_epoch(setup.jstep, setup.jstate, jl[0])
    port = setup.port_model()
    state = TrainState(port, select_optimizer(setup.opt_cfg, port.parameters()))
    got, _ = train_epoch(make_superstep(make_train_step(), 4), state, pl[0])
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert state.step == len(pl[0])


def test_run_training_takes_steps_per_dispatch_and_matches_k1(tmp_path):
    from hydragnn_tpu_torch import run_training

    samples = deterministic_graph_data(number_configurations=120, seed=7)
    history4: list = []
    state4, _, aug = run_training(_bucketed_config(k=4), samples=samples, device="cpu",
                                  path=str(tmp_path / "k4"), history=history4)
    assert resolve_steps_per_dispatch(aug["NeuralNetwork"]["Training"]) == 4

    # K = 1 over the same (bucket-major) plan: the loop with the loader set
    cfg1 = _bucketed_config(k=1)
    state1, loaders, aug1 = _fresh_port_state(cfg1, samples)
    natural = [c.tolist() for c, _ in loaders[0].batch_plan()]
    loaders[0].set_superstep(4)
    assert natural != [c.tolist() for c, _ in loaders[0].batch_plan()]
    history1: list = []
    train_validate_test(state1, *loaders, aug1["NeuralNetwork"], "k1", path=str(tmp_path),
                        history=history1)
    keys = ("train_loss", "val_loss", "test_loss")
    assert [[h[k] for k in keys] for h in history4] == [[h[k] for k in keys]
                                                        for h in history1]
    _assert_states_equal(state4, state1)


def test_prefetch_loader_passes_set_superstep_on_and_double_buffer_keeps_order():
    samples = deterministic_graph_data(number_configurations=40, seed=2)
    loader = GraphLoader(samples, 4, shuffle=True, seed=3, buckets=2)
    pf = PrefetchLoader(loader, depth=2)
    pf.set_superstep(3)
    assert loader.block == 3 and pf.superstep == 3
    got = [b.x for b in pf]
    want = [b.x for b in loader]
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))

    # the JAX package's double_buffer stages stacked blocks; the port's
    # blocks are their batches, which the prefetch thread already stages
    assert list(background_iter(iter(range(50)), depth=3)) == list(range(50))

    def broken():
        yield 1
        raise RuntimeError("staging failed")

    it = background_iter(broken())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="staging failed"):
        next(it)


def test_preserved_puts_a_train_state_back_exactly():
    """The warm-up runs before a capture are real steps: ``preserved`` must
    undo them, whether the optimizer had state or not, and leave the
    dropout generator where it was."""
    samples = deterministic_graph_data(number_configurations=40, seed=7)
    cfg = _bucketed_config()
    state, loaders, _ = _fresh_port_state(cfg, samples)
    twin, _, _ = _fresh_port_state(cfg, samples)
    batch = next(iter(loaders[0]))
    step = make_train_step()
    for _ in range(2):  # fresh optimizer state, then existing state
        gen_before = state.generator.get_state()
        with capture.preserved(state):
            step(state, batch)
            step(state, batch)
        assert torch.equal(state.generator.get_state(), gen_before)
        _assert_states_equal(state, twin)
        a, b = step(state, batch), step(twin, batch)
        assert torch.equal(a["loss"], b["loss"])
        _assert_states_equal(state, twin)


def test_cpu_route_runs_the_eager_step_and_captures_nothing():
    samples = deterministic_graph_data(number_configurations=40, seed=7)
    state, loaders, _ = _fresh_port_state(_bucketed_config(), samples)
    twin, _, _ = _fresh_port_state(_bucketed_config(), samples)
    batches = list(loaders[0])[:3]
    step = make_train_step()
    dispatch = capture.Dispatch(step, "train", train=True)
    before = capture.total_captures()
    with capture.no_new_captures("a CPU epoch"):
        got = [dispatch(state, b) for b in batches]
    want = [step(twin, b) for b in batches]
    assert all(torch.equal(g["loss"], w["loss"]) for g, w in zip(got, want))
    assert dispatch.graphs.captures == 0 and capture.total_captures() == before
    _assert_states_equal(state, twin)
    with pytest.raises(ValueError, match="run on the card"):
        capture.StepGraphs(lambda s, b: b, "x").capture(state, batches[0])


def test_graph_key_holds_the_sortedness_certificates():
    """A graph is keyed by the batch's sortedness certificates as well as
    its shapes, and its slots keep them, so the CSR views built inside it
    skip the argsorts the eager step skips; a graph that argsorts an array
    also serves a batch that certifies it sorted (a stable argsort leaves
    sorted ids in place), never the other way round."""
    import dataclasses

    samples = deterministic_graph_data(number_configurations=40, seed=7)
    batch = next(iter(GraphLoader(samples, 8, buckets=1)))
    meta = batch.meta
    assert meta.recv_sorted and meta.batch_sorted
    key = capture.signature(batch)
    assert key[2] == (meta.recv_sorted, meta.send_sorted, meta.batch_sorted)
    weaker = capture.signature(batch.replace(meta=dataclasses.replace(
        meta, recv_sorted=False, batch_sorted=False)))
    stronger = capture.signature(batch.replace(meta=dataclasses.replace(
        meta, send_sorted=True)))
    assert weaker != key and stronger != key
    assert capture._serves(key, key) and capture._serves(weaker, key)
    assert not capture._serves(key, weaker) and not capture._serves(stronger, key)
    other = next(iter(GraphLoader(samples[:20], 4, buckets=1)))
    assert not capture._serves(capture.signature(other), key)
    slots = capture._static_copy(batch, "cpu")
    assert slots.meta == meta
    view = slots.replace()
    assert view.csr("receivers").perm is None and view.csr("batch").perm is None


def test_optimizer_learning_rate_and_state_keep_their_tensors():
    params = [torch.nn.Parameter(torch.randn(5, generator=torch.Generator().manual_seed(1)))]
    assert select_optimizer({"type": "AdamW", "learning_rate": 0.01},
                            params).param_groups[0]["lr"] == 0.01  # the CPU keeps floats
    rate = torch.tensor(0.01)
    opt = torch.optim.AdamW(params, lr=rate, foreach=False)
    params[0].grad = torch.ones(5)
    opt.step()
    set_learning_rate(opt, 0.005)
    assert opt.param_groups[0]["lr"] is rate and float(rate) == float(np.float32(0.005))
    held = dict(opt.state[params[0]])
    saved = copy.deepcopy(opt.state_dict())
    opt.step()
    load_optimizer_state(opt, saved)
    assert opt.param_groups[0]["lr"] is rate and float(rate) == float(np.float32(0.005))
    for key, t in opt.state[params[0]].items():
        assert t is held[key] and torch.equal(t, saved["state"][0][key]), key


def test_capturable_optimizers_keep_torchs_state_and_load_its_checkpoints():
    """The card's optimizers keep ``torch.optim``'s state (keys, step count
    as float32) and restore from its checkpoints and into them; their
    update is torch's bit for bit on the card (``test_torch_capture_gpu``),
    here within one float32 rounding (the CPU's kernels fuse other
    multiply-adds)."""
    gen = torch.Generator().manual_seed(2)
    shapes = [(7,), (5, 3)]
    ours = [torch.nn.Parameter(torch.randn(s, generator=gen)) for s in shapes]
    theirs = [torch.nn.Parameter(p.detach().clone()) for p in ours]
    rate = torch.tensor(0.01, dtype=torch.float64)
    cap = CapturableAdam(ours, rate, weight_decay=1e-4, decoupled=True)
    ref = torch.optim.AdamW(theirs, lr=0.01, weight_decay=1e-4)
    for _ in range(3):
        grads = [torch.randn(s, generator=gen) for s in shapes]
        for p, q, g in zip(ours, theirs, grads):
            p.grad, q.grad = g.clone(), g.clone()
        cap.step()
        ref.step()
    for p, q in zip(ours, theirs):
        torch.testing.assert_close(p, q, rtol=0, atol=2.4e-7)
    assert set(cap.state[ours[0]]) == set(ref.state[theirs[0]])
    assert cap.state[ours[0]]["step"].dtype == torch.float32 and float(
        cap.state[ours[0]]["step"]) == 3.0
    held = cap.state[ours[0]]["exp_avg"]
    load_optimizer_state(cap, ref.state_dict())  # torch's checkpoint into ours
    assert cap.state[ours[0]]["exp_avg"] is held and cap.param_groups[0]["lr"] is rate
    assert torch.equal(held, ref.state[theirs[0]]["exp_avg"])
    load_optimizer_state(ref, cap.state_dict())  # and back
    assert ref.param_groups[0]["lr"] == 0.01 and "decoupled" not in ref.param_groups[0]

    sgd = [torch.nn.Parameter(torch.randn(7, generator=gen))]
    plain = [torch.nn.Parameter(sgd[0].detach().clone())]
    sgd[0].grad = plain[0].grad = torch.randn(7, generator=gen)
    CapturableSGD(sgd, lr=torch.tensor(0.1, dtype=torch.float64)).step()
    torch.optim.SGD(plain, lr=0.1).step()
    assert torch.equal(sgd[0], plain[0])


def _nonzero_dense_edges(pos, cutoff, max_edges, geo, pad_id):
    """The dense build as it was with ``torch.nonzero`` (the reference)."""
    from hydragnn_tpu_torch.ops.fused_cell_list import mat3

    n = pos.shape[0]
    disp = pos[None, :, :] - pos[:, None, :]
    shift = torch.zeros_like(disp)
    if geo is not None:
        cellm, inv, pbcf = geo
        shift = -mat3(torch.round(mat3(disp, inv)) * pbcf, cellm)
        disp = disp + shift
    d2 = disp[..., 0] * disp[..., 0] + disp[..., 1] * disp[..., 1] + disp[..., 2] * disp[..., 2]
    c2 = torch.tensor(float(cutoff) * float(cutoff), dtype=pos.dtype)
    within = (d2 <= c2) & ~torch.eye(n, dtype=torch.bool)
    n_edges = within.sum().to(torch.int32)
    flat = torch.nonzero(within.reshape(-1)).reshape(-1)[:max_edges]
    flat = torch.cat([flat, flat.new_zeros(max_edges - flat.shape[0])])
    live = torch.arange(max_edges) < n_edges
    edge_mask = live.to(pos.dtype)
    senders = (flat // n).to(torch.int32)
    receivers = (flat % n).to(torch.int32)
    shifts = shift[senders.long(), receivers.long()] * edge_mask[:, None]
    senders = torch.where(live, senders, pad_id).to(torch.int32)
    receivers = torch.where(live, receivers, pad_id).to(torch.int32)
    return senders, receivers, shifts, edge_mask, n_edges


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("max_edges", [40, 600, 3000])
def test_dense_compaction_gives_nonzero_edges(periodic, max_edges):
    from hydragnn_tpu_torch.md import _dense_edges, compact_pairs
    from hydragnn_tpu_torch.ops.fused_cell_list import geometry

    rng = np.random.default_rng(max_edges)
    pos = torch.from_numpy(rng.uniform(0, 6.0, size=(50, 3)).astype(np.float32))
    geo = geometry(np.diag([6.0, 6.0, 6.0]), np.ones(3, bool), torch.float32,
                   "cpu") if periodic else None
    got = _dense_edges(pos, 2.0, max_edges, geo, pad_id=49)
    want = _nonzero_dense_edges(pos, 2.0, max_edges, geo, pad_id=49)
    for name, a, b in zip(("senders", "receivers", "shifts", "edge_mask", "n_edges"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    mask = torch.from_numpy(rng.random(1000) < 0.1)
    for cap in (1, 37, 100, 1000):
        flat, count = compact_pairs(mask, cap)
        ref = torch.nonzero(mask).reshape(-1)[:cap]
        assert torch.equal(flat[:ref.shape[0]], ref) and not flat[ref.shape[0]:].any()
        assert int(count) == int(mask.sum())
