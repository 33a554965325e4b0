"""The port's CUDA graphs (``hydragnn_tpu_torch/capture.py``) against the
eager steps they capture, on the card: predict, int8 predict, eval, train
(fp32 and bf16, dropout from the registered generator, a changed learning
rate), supersteps (a block of four and a shorter tail), the CSR tickets
after replays, ``no_new_captures``, launch records, and the MD trajectory
segment on both neighbour routes. Every comparison is bit for bit: a
replay runs the kernels the eager step launches, in its order. The qm9
models of ``chip_smoke.py`` (GIN, GAT, GPS-GIN, the six invariant and the
four geometric stacks at their published widths, random weights from seed
0) at the top pad bucket, and the EGNN, PAINN and MACE interatomic
potentials.

Every test is ``gpu``-marked and skips without a CUDA device. The file
imports neither JAX nor ``tests/conftest.py``'s helpers:

    python -m pytest tests/test_torch_capture_gpu.py -m gpu --noconftest -q
"""

import copy
import functools

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch thread)
from hydragnn_tpu_torch import capture
from hydragnn_tpu_torch.graphs.batching import collate, compute_pad_buckets
from hydragnn_tpu_torch.ops import fused_scatter as fs

pytestmark = pytest.mark.gpu

KINDS = ("gin", "gat", "gps")


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _qm9(kind: str):
    import chip_smoke

    _, aug, loaders, samples = chip_smoke.prepare(0, kind)
    train = loaders[0].samples
    top = compute_pad_buckets(samples, 64, max_buckets=4)[-1]  # the serving table's
    batches = [collate(train[i:i + 64], top) for i in range(0, 384, 64)]
    _, small = chip_smoke.bucket_batches(loaders, samples)
    return kind, aug, batches, small


@pytest.fixture(params=KINDS)
def qm9(request):
    """(kind, augmented config, six top-bucket host batches of 64 training
    samples, a host batch of the smallest bucket or None)."""
    _cuda_or_skip()
    return _qm9(request.param)


def _state(aug, dropout=None, seed=0):
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.train.step import create_train_state

    aug = copy.deepcopy(aug)
    if dropout is not None:
        aug["NeuralNetwork"]["Architecture"]["dropout"] = dropout
    model = create_model_config(aug, device="cuda", seed=seed)
    return create_train_state(model, aug["NeuralNetwork"]["Training"]["Optimizer"], seed)


def _assert_same(a, b, what=""):
    for (name, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), f"{what}{name}"
    for sa, sb in zip(a.optimizer.state.values(), b.optimizer.state.values()):
        for key in sa:
            assert torch.equal(sa[key], sb[key]), f"{what}optimizer {key}"
    assert torch.equal(a.optimizer.param_groups[0]["lr"], b.optimizer.param_groups[0]["lr"])
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state()), f"{what}generator"


def _same_tree(x, y) -> bool:
    if torch.is_tensor(x):
        return torch.equal(x, y)
    if isinstance(x, dict):
        return all(_same_tree(x[k], y[k]) for k in x)
    return all(_same_tree(a, b) for a, b in zip(x, y, strict=True))


def _launches(fn):
    fs.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(fs.LAUNCHES)


def test_captured_predict_int8_and_eval_equal_eager(qm9):
    from hydragnn_tpu_torch.serve import Predictor
    from hydragnn_tpu_torch.serve import quant as sq
    from hydragnn_tpu_torch.train.step import make_eval_step

    kind, aug, batches, _ = qm9
    state = _state(aug)
    pred = Predictor(state.model, aug, device="cuda")
    dev = [b.to("cuda") for b in batches[:3]]
    scales = sq.collect_activation_scales(pred.model, dev[:2], pred.compute_dtype)
    int8 = sq.make_quantized_predict_step(pred.model, scales,
                                          sq.quantize_dense_weights(pred.model, scales),
                                          pred.compute_dtype)
    eval_step = make_eval_step(pred.compute_dtype)
    evals = capture.Dispatch(eval_step, "eval")
    for step in (None, int8):
        for host, b in zip(batches, dev):
            got, replayed = _launches(lambda: pred.answer(host, step=step))
            want, eager = _launches(lambda: pred.outputs(b, step=step))
            assert _same_tree(got, want), f"{kind} predict {'int8' if step else 'fp32'}"
            assert replayed == eager and sum(eager.values()) > 0
    for b in dev:
        got, replayed = _launches(lambda: evals(state, b))
        want, eager = _launches(lambda: eval_step(state, b))
        assert _same_tree(got, want) and replayed == eager, f"{kind} eval"
    assert pred.captures() == 2 and evals.graphs.captures == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_captured_train_steps_equal_eager_steps(qm9, dtype):
    """Four steps each way, the learning rate halved before the last: the
    parameters, running statistics, AdamW moments and step counts, the
    dropout generator (GAT's and GPS's attention dropout is on) and every
    metric bit-equal; one replay launches what one eager step does."""
    from hydragnn_tpu_torch.train.optimizer import set_learning_rate
    from hydragnn_tpu_torch.train.step import make_train_step

    kind, aug, batches, _ = qm9
    step = make_train_step(dtype)
    captured, eager = _state(aug), _state(aug)
    dispatch = capture.Dispatch(step, "train", train=True)
    for i, host in enumerate(batches[:4]):
        if i == 3:
            for s in (captured, eager):
                set_learning_rate(s.optimizer, 5e-4)
        b = host.to("cuda")
        got, replayed = _launches(lambda: dispatch(captured, b))
        want, launched = _launches(lambda: step(eager, b))
        assert _same_tree(got, want), f"{kind} step {i} metrics"
        assert replayed == launched, f"{kind} step {i} launches"
        _assert_same(captured, eager, f"{kind} step {i}: ")
    assert dispatch.graphs.captures == 1 and captured.step == 4


@pytest.mark.parametrize("kind", ["sage", "mfc", "schnet", "pna", "pnaplus", "cgcnn"])
def test_invariant_stacks_captured_steps_equal_eager_steps(kind):
    """The six invariant stacks at qm9.json's widths (``chip_smoke.STACKS``):
    two bf16 train steps, an eval and a predict step, each replayed from its
    CUDA graph bit-equal to the eager step, with the same launches."""
    _stack_steps_equal_eager(kind)


@pytest.mark.parametrize("kind", ["painn", "pnaeq", "dimenet", "mace"])
def test_geometric_stacks_captured_steps_equal_eager_steps(kind):
    """The four geometric stacks at qm9.json's widths
    (``chip_smoke.GEOMETRIC``; DimeNet's batches carry their triplets and
    its step its CSR views of ``idx_ji`` and ``idx_kj``), the same way."""
    _stack_steps_equal_eager(kind)


def _stack_steps_equal_eager(kind):
    from hydragnn_tpu_torch.serve import Predictor
    from hydragnn_tpu_torch.train.step import make_eval_step, make_train_step

    _cuda_or_skip()
    _, aug, batches, _ = _qm9(kind)
    step, eval_step = make_train_step(torch.bfloat16), make_eval_step(torch.bfloat16)
    captured, eager = _state(aug), _state(aug)
    train, evals = capture.Dispatch(step, "train", train=True), capture.Dispatch(eval_step, "eval")
    for i, host in enumerate(batches[:2]):
        b = host.to("cuda")
        got, replayed = _launches(lambda: train(captured, b))
        want, launched = _launches(lambda: step(eager, b))
        assert _same_tree(got, want) and replayed == launched, f"{kind} step {i}"
        _assert_same(captured, eager, f"{kind} step {i}: ")
    b = batches[2].to("cuda")
    got, replayed = _launches(lambda: evals(captured, b))
    want, launched = _launches(lambda: eval_step(eager, b))
    assert _same_tree(got, want) and replayed == launched, f"{kind} eval"
    pred = Predictor(captured.model, aug, device="cuda")
    got, replayed = _launches(lambda: pred.answer(batches[3]))
    want, launched = _launches(lambda: pred.outputs(batches[3].to("cuda")))
    assert _same_tree(got, want) and replayed == launched and sum(launched.values()) > 0


@pytest.mark.parametrize("kind", ["gat", "gps"])
def test_dropout_masks_come_from_the_registered_generator(kind):
    """At dropout 0.5 (GAT's and GPS's attention and layer dropout) the
    captured steps draw the eager steps' masks: the generator advances as
    it would, and the steps differ from one another."""
    from hydragnn_tpu_torch.train.step import make_train_step

    _cuda_or_skip()
    _, aug, batches, _ = _qm9(kind)
    step = make_train_step(torch.float32)
    captured, eager = _state(aug, dropout=0.5), _state(aug, dropout=0.5)
    start = captured.generator.get_state()
    dispatch = capture.Dispatch(step, "train", train=True)
    b = batches[0].to("cuda")
    losses = []
    for _ in range(3):
        got, want = dispatch(captured, b), step(eager, b)
        assert torch.equal(got["loss"], want["loss"])
        losses.append(float(got["loss"]))
    _assert_same(captured, eager)
    assert not torch.equal(captured.generator.get_state(), start)
    assert len(set(losses)) == 3


def test_superstep_equals_four_eager_steps_and_a_shorter_tail(qm9):
    from hydragnn_tpu_torch.train.step import make_train_step
    from hydragnn_tpu_torch.train.superstep import make_superstep

    kind, aug, batches, _ = qm9
    step = make_train_step(torch.bfloat16)
    blocked, eager = _state(aug), _state(aug)
    superstep = make_superstep(step, 4)
    dev = [b.to("cuda") for b in batches]
    got, replayed = _launches(lambda: superstep(blocked, dev[:4]))
    want, launched = _launches(lambda: [step(eager, b) for b in dev[:4]])
    assert _same_tree(got, want) and replayed == launched
    _assert_same(blocked, eager, f"{kind} block: ")
    tail = superstep(blocked, dev[4:6])
    assert _same_tree(tail, [step(eager, b) for b in dev[4:6]])
    _assert_same(blocked, eager, f"{kind} tail: ")
    # one graph per bucket: every block replays the one-step graph
    assert superstep.dispatch.graphs.stats()["captures"] == 1


def test_replays_put_the_csr_tickets_back(qm9):
    """B2's and B3's per-row tickets are 0 after every replay, in every
    view the captured run built (GAT's self-loop views carry B3's)."""
    from hydragnn_tpu_torch.train.step import make_train_step

    kind, aug, batches, _ = qm9
    state = _state(aug)
    dispatch = capture.Dispatch(make_train_step(torch.bfloat16), "train", train=True)
    for host in batches[:3]:
        dispatch(state, host.to("cuda"))
    torch.cuda.synchronize()
    (graph,) = dispatch.graphs.graphs.values()
    views = graph.view._csr
    want = {"gin": {"receivers", "senders", "batch"}, "gps": {"receivers", "senders", "batch"},
            "gat": {"loop_receivers", "loop_senders", "batch"}}[kind]
    assert want <= set(views)
    meta = batches[0].meta  # the slots keep the batch's certificates
    for name, flag in (("receivers", meta.recv_sorted), ("senders", meta.send_sorted),
                       ("batch", meta.batch_sorted)):
        if name in views:
            assert (views[name].perm is None) == flag, f"{kind} {name}: argsort"
    for name, index in views.items():
        if isinstance(index, fs.SegmentIndex):
            assert int(index.tickets.abs().sum()) == 0, f"{kind} {name} tickets"


def test_no_new_captures_raises_on_a_new_bucket_only(qm9):
    from hydragnn_tpu_torch.serve import Predictor

    kind, aug, batches, small = qm9
    pred = Predictor(_state(aug).model, aug, device="cuda")
    pred.answer(batches[0])
    with capture.no_new_captures(f"{kind} steady state"):
        pred.answer(batches[1])
        if small is not None:
            with pytest.raises(capture.NewCaptureError, match="steady state"):
                pred.answer(small)
    assert pred.captures() == 1
    if small is not None:
        pred.answer(small)
        assert pred.captures() == 2


def test_captured_mlip_train_steps_equal_eager_steps():
    """The EGNN MLIP step (forces from a gradient with ``create_graph``,
    the loss's backward through it) captured against eager, fp32."""
    _cuda_or_skip()
    import chip_smoke
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.models.mlip import make_mlip_train_step
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting

    cfg = chip_smoke.mlip_config(1)
    loaders = dataset_loading_and_splitting(copy.deepcopy(cfg),
                                            samples=chip_smoke.mlip_samples(192))
    aug = update_config(copy.deepcopy(cfg), *(ld.samples for ld in loaders))
    captured, eager = _state(aug), _state(aug)
    step = make_mlip_train_step(captured.model, torch.float32)
    dispatch = capture.Dispatch(step, "mlip train", train=True)
    train = loaders[0]
    for i in range(2):
        b = collate(train.samples[64 * i:64 * (i + 1)], train.pad).to("cuda")
        got, replayed = _launches(lambda: dispatch(captured, b))
        want, launched = _launches(lambda: step(eager, b))
        assert _same_tree(got, want) and replayed == launched
        _assert_same(captured, eager, f"mlip step {i}: ")


@pytest.mark.parametrize("arch", ["PAINN", "MACE"])
def test_captured_geometric_mlip_train_steps_equal_eager_steps(arch):
    """PAINN and MACE as interatomic potentials (``examples/oc20/train.py``'s
    block on the oc20 row's data, ``chip_smoke.mlip_config``): two fp32 MLIP
    train steps and an eval step captured against eager."""
    _cuda_or_skip()
    import chip_smoke
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.models.mlip import make_mlip_eval_step, make_mlip_train_step
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting

    cfg = chip_smoke.mlip_config(1, arch)
    loaders = dataset_loading_and_splitting(copy.deepcopy(cfg),
                                            samples=chip_smoke.mlip_samples(192))
    aug = update_config(copy.deepcopy(cfg), *(ld.samples for ld in loaders))
    captured, eager = _state(aug), _state(aug)
    step = make_mlip_train_step(captured.model, torch.float32)
    eval_step = make_mlip_eval_step(captured.model, torch.float32)
    dispatch = capture.Dispatch(step, f"{arch} mlip train", train=True)
    evals = capture.Dispatch(eval_step, f"{arch} mlip eval")
    train = loaders[0]
    for i in range(2):
        b = collate(train.samples[64 * i:64 * (i + 1)], train.pad).to("cuda")
        got, replayed = _launches(lambda: dispatch(captured, b))
        want, launched = _launches(lambda: step(eager, b))
        assert _same_tree(got, want) and replayed == launched
        assert launched == chip_smoke.mlip_launches_per_step(
            int(aug["NeuralNetwork"]["Architecture"]["num_conv_layers"]), arch)
        _assert_same(captured, eager, f"{arch} mlip step {i}: ")
    b = collate(train.samples[:64], train.pad).to("cuda")
    got, replayed = _launches(lambda: evals(captured, b))
    want, launched = _launches(lambda: eval_step(eager, b))
    assert _same_tree(got, want) and replayed == launched


@pytest.mark.parametrize("system", ["lj", "mlip"])
@pytest.mark.parametrize("neighbor", ["cell", "dense"])
def test_captured_md_segments_equal_the_eager_trajectory(system, neighbor):
    """``run_md`` on the card (segments of 5 steps replayed) against the
    eager steps, every recorded field bit for bit, and one replay's
    launches are five eager steps'."""
    _cuda_or_skip()
    import chip_smoke
    from hydragnn_tpu_torch import md
    from hydragnn_tpu_torch.graphs.batching import PadSpec

    steps, every = 20, 5
    if system == "lj":
        pos, vel, cell = chip_smoke.lj_lattice(8)
        energy_fn = chip_smoke.lj_energy(torch)
        cutoff, max_edges, pad_id = chip_smoke.LJ_MD_CUTOFF, 60 * pos.shape[0], 0
    else:
        from hydragnn_tpu_torch.config import update_config
        from hydragnn_tpu_torch.models import create_model_config

        from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting

        cfg = chip_smoke.mlip_config(1)  # the loading records the feature ranges in it
        loaders = dataset_loading_and_splitting(cfg, samples=chip_smoke.mlip_samples(32))
        aug = update_config(cfg, *(ld.samples for ld in loaders))
        model = create_model_config(aug, device="cuda", seed=0).eval()
        sample = chip_smoke.mlip_md_sample(aug, cells_per_dim=6)
        n = sample.num_nodes
        pos = sample.pos.astype(np.float32)
        vel = (0.1 * np.random.default_rng(1).normal(size=(n, 3))).astype(np.float32)
        cell = sample.cell.astype(np.float32)
        cutoff, max_edges = float(aug["NeuralNetwork"]["Architecture"]["radius"]), 16 * n
        pad = PadSpec(n_node=n + 8, n_edge=max_edges, n_graph=2)
        pad_id = pad.n_node - 1
        energy_fn = md.mlip_energy_fn(model, collate([sample], pad).to("cuda"))
    masses = np.ones(pos.shape[0], np.float32)
    kw = dict(cell=cell, pbc=np.ones(3, bool), pad_id=pad_id, neighbor=neighbor)
    p0, v0 = torch.from_numpy(pos).cuda(), torch.from_numpy(vel).cuda()
    fs.reset_launches()
    final, traj = md.run_md(energy_fn, p0, v0, masses, 1e-3, steps, cutoff, max_edges,
                            record_every=every, **kw)
    torch.cuda.synchronize()
    replayed = dict(fs.LAUNCHES)
    init, step = md.make_md_step(energy_fn, masses, 1e-3, cutoff, max_edges, **kw)
    state = init(p0, v0)
    recorded = []
    fs.reset_launches()
    for k in range(steps):
        state = step(state)
        if (k + 1) % every == 0:
            recorded.append(state)
    torch.cuda.synchronize()
    eager = dict(fs.LAUNCHES)
    for name, got, want in zip(md.MDState._fields, traj,
                               (torch.stack(f) for f in zip(*recorded))):
        assert torch.equal(got, want), f"{system}/{neighbor} {name}"
    assert all(torch.equal(a, b) for a, b in zip(final, state))
    # run_md's init is one more force evaluation, as many launches as a step
    per_step = {k: v // steps for k, v in eager.items()}
    assert eager == {k: v * steps for k, v in per_step.items()} and per_step["segment_sum"]
    assert replayed == {k: v + per_step[k] for k, v in eager.items()}
    assert int(final.max_n_edges) <= max_edges


@pytest.mark.parametrize("kind", ["adamw", "adam", "sgd"])
def test_capturable_optimizers_are_torchs_bit_for_bit(kind):
    """The card's optimizers against ``torch.optim``'s (foreach, float
    learning rate) over 40 steps of gradients from 1e-2 to 1e2, the rate
    halved at step 20, eager and replayed from a graph; and the float32
    step sizes and bias corrections they compute on the card against the
    host's double-precision ones for 200,000 steps (the card's float64
    ``pow`` differs from the host's in the last place at some steps; the
    float32 roundings do not)."""
    from hydragnn_tpu_torch.train.optimizer import (CapturableAdam, CapturableSGD,
                                                    set_learning_rate)

    dev = _cuda_or_skip()
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [(7,), (33, 17), (64, 64), (1,), (384, 384), (1000, 3)]
    ref_p = [torch.nn.Parameter(torch.randn(s, generator=gen, device=dev)) for s in shapes]
    ours_p = [torch.nn.Parameter(p.detach().clone()) for p in ref_p]
    graph_p = [torch.nn.Parameter(p.detach().clone()) for p in ref_p]

    def rate():
        return torch.full((), 1e-3, dtype=torch.float64, device=dev)

    if kind == "sgd":
        ref = torch.optim.SGD(ref_p, lr=1e-3)
        ours, graphed = CapturableSGD(ours_p, rate()), CapturableSGD(graph_p, rate())
    else:
        wd = 1e-4 if kind == "adamw" else 0.0
        ref = (torch.optim.AdamW(ref_p, lr=1e-3, weight_decay=wd) if kind == "adamw"
               else torch.optim.Adam(ref_p, lr=1e-3))
        ours = CapturableAdam(ours_p, rate(), weight_decay=wd, decoupled=kind == "adamw")
        graphed = CapturableAdam(graph_p, rate(), weight_decay=wd, decoupled=kind == "adamw")
    grads = [torch.empty(s, device=dev) for s in shapes]
    for p, g in zip(graph_p, grads):
        p.grad = g
    graph = None
    for it in range(40):
        if it == 20:
            for opt in (ref, ours, graphed):
                set_learning_rate(opt, 5e-4)
        for g in grads:
            g.copy_(torch.randn(g.shape, generator=gen, device=dev) * 10.0 ** (it % 5 - 2))
        for p, q, g in zip(ref_p, ours_p, grads):
            p.grad, q.grad = g.clone(), g.clone()
        ref.step()
        ours.step()
        if graph is None:  # the first step builds the state; the graph holds the next
            graphed.step()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                graphed.step()
        else:
            graph.replay()
        for a, b, c in zip(ref_p, ours_p, graph_p):
            assert torch.equal(a, b) and torch.equal(a, c), f"{kind} step {it}"

    t = torch.arange(1, 200001, dtype=torch.float64, device=dev)
    sizes = (-(1e-3 / (1 - torch.pow(0.9, t)))).float().cpu()
    corr = torch.pow(1 - torch.pow(0.999, t), 0.5).float().cpu()
    host = torch.tensor([[(1e-3 / (1 - 0.9 ** float(k))) * -1, (1 - 0.999 ** float(k)) ** 0.5]
                         for k in range(1, 200001)], dtype=torch.float64).float()
    assert torch.equal(sizes, host[:, 0]) and torch.equal(corr, host[:, 1])
