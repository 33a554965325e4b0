"""The port's CUDA kernels (segment reductions, softmaxes, the cell list, the
int8 and fp8 dense layers) against their plain PyTorch versions, on the
card, at the main paths' layouts (DimeNet's triplet mixing, the
geometric stacks' flattened 3-D messages, the performer's per-graph sums,
GAT's self-loop mean and the edge Dense layers included). Every test here is ``gpu``-marked and
skips without a CUDA device.

The file imports neither JAX nor ``tests/conftest.py``'s helpers, so it
also runs on a machine that has the card but no JAX:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest -q

Tolerances as in ``chip_smoke.py``: fp32 sums differ only in the order of
additions (the plain version's ``index_add_`` uses atomics on the card), so
rtol/atol 1e-5; bf16 outputs may differ by one bf16 rounding of those sums,
so rtol/atol 1e-2. Real rows only (row N-1 is the pad edges' dummy row).
"""

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch thread)
from hydragnn_tpu_torch.graphs.batching import collate, compute_pad_spec
from hydragnn_tpu_torch.graphs.graph import GraphSample
from hydragnn_tpu_torch.graphs.radius import radius_graph
from hydragnn_tpu_torch.ops import fused_scatter as fs
from hydragnn_tpu_torch.ops import fused_softmax as fsm

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(scope="module")
def batch():
    """16 QM9-sized molecules collated on the host (receivers sorted)."""
    rng = np.random.default_rng(3)
    samples = []
    for _ in range(16):
        na = int(rng.integers(9, 30))
        pos = rng.uniform(0, 6.0, size=(na, 3))
        s, r, sh = radius_graph(pos, radius=3.0, max_neighbours=20)
        samples.append(GraphSample(x=rng.normal(size=(na, 1)), pos=pos, senders=s,
                                   receivers=r, edge_shifts=sh))
    return collate(samples, compute_pad_spec(samples, 16))


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_gather_scatter_kernel_matches_plain_on_card(batch, dtype):
    dev = _cuda_or_skip()
    b = batch.to(dev)
    n = b.num_nodes
    h = torch.randn(n, 64, generator=torch.Generator().manual_seed(0)).to(dev, dtype)
    w = b.edge_mask.to(dtype)
    before = fs.LAUNCHES["gather_scatter_sum"]
    got = fs.gather_scatter_sum(h, b.senders, b.receivers, n, weight=w, index=b.csr("receivers"))
    torch.cuda.synchronize()
    assert fs.LAUNCHES["gather_scatter_sum"] == before + 1
    want = fs.plain_gather_scatter_sum(h, b.senders, b.receivers, n, w)
    torch.testing.assert_close(got[: n - 1].float(), want[: n - 1].float(), **TOL[dtype])
    with pytest.raises(ValueError, match="index built for"):
        fs.gather_scatter_sum(h, b.senders[:-1], b.receivers[:-1], n, index=b.csr("receivers"))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fs.gather_scatter_sum(h.half(), b.senders, b.receivers, n)
    with pytest.raises(ValueError, match="all inputs must be on"):
        fs.gather_scatter_sum(h, b.senders.cpu(), b.receivers, n)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_segment_sum_kernel_matches_plain_on_card(batch, dtype):
    dev = _cuda_or_skip()
    b = batch.to(dev)
    n, g = b.num_nodes, b.num_graphs
    x = torch.randn(n, 64, generator=torch.Generator().manual_seed(1)).to(dev, dtype)
    before = fs.LAUNCHES["segment_sum"]
    got = fs.fused_segment_sum(x, b.batch, g, index=b.csr("batch"))
    torch.cuda.synchronize()
    assert fs.LAUNCHES["segment_sum"] == before + 1
    want = fs.plain_segment_sum(x, b.batch, g)
    torch.testing.assert_close(got[: g - 1].float(), want[: g - 1].float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("c", [1, 64, 100])
@pytest.mark.parametrize("wkind", ["none", "edge", "channel"])
@pytest.mark.parametrize("layout", ["sorted", "unsorted", "hubs"])
def test_gather_scatter_kernel_cases_on_card(batch, dtype, c, wkind, layout):
    """Channel counts below, at and above one warp pass (64), every weight
    form, unsorted ids (the stable-sort permutation) and hub rows of many
    32-edge pieces (the combine kernel), against the plain version."""
    dev = _cuda_or_skip()
    gen = torch.Generator().manual_seed(c)
    b = batch.to(dev)
    n, e = b.num_nodes, b.num_edges
    s, r = b.senders, b.receivers
    if layout == "unsorted":
        p = torch.randperm(e, generator=gen).to(dev)
        s, r = s[p], r[p]
    elif layout == "hubs":  # every edge onto one of 4 rows: ~E/4 edges each
        r = torch.sort(torch.randint(0, 4, (e,), generator=gen)).values.to(dev, torch.int32)
    h = torch.randn(n, c, generator=gen).to(dev, dtype)
    w = {"none": None, "edge": torch.rand(e, generator=gen),
         "channel": torch.rand(e, c, generator=gen)}[wkind]
    w = None if w is None else w.to(dev, dtype)
    got = fs.gather_scatter_sum(h, s, r, n, weight=w)
    want = fs.plain_gather_scatter_sum(h, s, r, n, w)
    if layout == "hubs":
        # ~1,000-edge rows: the kernel's pieces and the plain version's
        # atomics add in different orders; compare with a bound on the
        # row's sum of |terms| (below 49 * 2^-24 of it, see chip_smoke.py)
        terms = h.double()[s.long()] * (1.0 if w is None else
                                        (w.double() if w.dim() == 2 else w.double()[:, None]))
        ref = torch.zeros(n, c, dtype=torch.float64, device=dev).index_add_(0, r.long(), terms)
        scale = torch.zeros_like(ref).index_add_(0, r.long(), terms.abs())
        bound = (1e-5 if dtype == torch.float32 else 1e-2) * scale + 1e-6
        assert bool(((got.double() - ref).abs() <= bound).all())
    else:
        torch.testing.assert_close(got[: n - 1].float(), want[: n - 1].float(), **TOL[dtype])


def test_no_edges_on_card(batch):
    dev = _cuda_or_skip()
    n = batch.num_nodes
    h = torch.randn(n, 64, device=dev)
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    out = fs.gather_scatter_sum(h, empty, empty, n)
    seg = fs.fused_segment_sum(torch.zeros(0, 64, device=dev), empty, n)
    torch.cuda.synchronize()
    assert not out.any() and not seg.any() and out.shape == (n, 64) == seg.shape


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_segment_sum_unsorted_and_wide_on_card(batch, dtype):
    dev = _cuda_or_skip()
    gen = torch.Generator().manual_seed(5)
    b = batch.to(dev)
    e = b.num_edges
    ids = b.receivers[torch.randperm(e, generator=gen).to(dev)]
    data = torch.randn(e, 100, generator=gen).to(dev, dtype)
    got = fs.fused_segment_sum(data, ids, b.num_nodes)
    want = fs.plain_segment_sum(data, ids, b.num_nodes)
    torch.testing.assert_close(got[:-1].float(), want[:-1].float(), **TOL[dtype])


# -- the backward: the transposed launch over the senders' CSR view ------------


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("wkind", ["edge", "channel"])
@pytest.mark.parametrize("c", [1, 64])
@pytest.mark.parametrize("given_index", [True, False], ids=["send_index", "built"])
def test_gather_scatter_backward_on_card(batch, dtype, wkind, c, given_index):
    """dh is the kernel launched again with senders and receivers swapped
    (row N-1 of the senders' view owns every pad edge, so the piece and
    combine path runs), dw is <h[s_e], dout[r_e]>; both against the plain
    versions on the card."""
    dev = _cuda_or_skip()
    gen = torch.Generator().manual_seed(c + 7)
    b = batch.to(dev)
    n, e = b.num_nodes, b.num_edges
    assert not b.meta.send_sorted, "collated senders need the permutation"
    h = torch.randn(n, c, generator=gen).to(dev, dtype).requires_grad_()
    w = (torch.rand(e, generator=gen) if wkind == "edge" else torch.rand(e, c, generator=gen))
    w = (w.to(dev) * (b.edge_mask if wkind == "edge" else b.edge_mask[:, None])).to(dtype)
    w.requires_grad_()
    dout = torch.randn(n, c, generator=gen).to(dev, dtype)
    before = dict(fs.LAUNCHES)
    out = fs.gather_scatter_sum(h, b.senders, b.receivers, n, weight=w,
                                index=b.csr("receivers"),
                                send_index=b.csr("senders") if given_index else None)
    out.backward(dout)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["gather_scatter_sum"] == before["gather_scatter_sum"] + 1
    assert fs.LAUNCHES["gather_scatter_sum_bwd"] == before["gather_scatter_sum_bwd"] + 1
    want_dh = fs.plain_gather_scatter_sum(dout, b.receivers, b.senders, n, w.detach())
    torch.testing.assert_close(h.grad[: n - 1].float(), want_dh[: n - 1].float(), **TOL[dtype])
    hs = h.detach().float()[b.senders.long()]
    dr = dout.float()[b.receivers.long()]
    want_dw = (hs * dr if wkind == "channel" else (hs * dr).sum(-1)).to(dtype)
    torch.testing.assert_close(w.grad.float(), want_dw.float(), **TOL[dtype])


def test_gather_scatter_at_schnets_shape_on_card():
    """B1 at SchNet's sum on the qm9 top pad bucket of ``chip_smoke.py``
    (N = 1,864, E = 17,792): ``[N, 64]`` features, a weight per edge and
    channel ``[E, 64]``, fp32 and bf16; the forward, the transposed launch
    and the filters' gradient through autograd, one launch each, against the
    plain version's autograd (``chip_smoke.schnet_gather_scatter_checks``)."""
    dev = _cuda_or_skip()
    import chip_smoke

    _, _, loaders, samples = chip_smoke.prepare(0)
    top, _ = chip_smoke.bucket_batches(loaders, samples)
    b = top.to(dev)
    chip_smoke.schnet_gather_scatter_checks(torch, b, torch.Generator().manual_seed(5),
                                            b.num_nodes - 1)
    torch.cuda.synchronize()


def test_gather_scatter_backward_is_bit_stable_on_card(batch):
    dev = _cuda_or_skip()
    b = batch.to(dev)
    n = b.num_nodes
    dout = torch.randn(n, 64, generator=torch.Generator().manual_seed(3)).to(dev)
    grads = []
    for _ in range(2):
        h = torch.zeros(n, 64, device=dev, requires_grad=True)
        fs.gather_scatter_sum(h, b.senders, b.receivers, n, weight=b.edge_mask,
                              index=b.csr("receivers"), send_index=b.csr("senders")
                              ).backward(dout)
        grads.append(h.grad)
    assert torch.equal(grads[0], grads[1])


def test_segment_sum_backward_on_card(batch):
    dev = _cuda_or_skip()
    b = batch.to(dev)
    x = torch.randn(b.num_nodes, 64, device=dev, requires_grad=True)
    dout = torch.randn(b.num_graphs, 64, device=dev)
    fs.fused_segment_sum(x, b.batch, b.num_graphs, index=b.csr("batch")).backward(dout)
    assert torch.equal(x.grad, dout[b.batch.long()])


def _qm9_model(dev, **arch):
    """The qm9.json model (hidden 64, 4 conv layers) with ``arch`` overrides,
    on ``dev``, and its train state."""
    import pathlib

    from hydragnn_tpu_torch.config import load_config, update_config
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.train.step import create_train_state

    cfg = load_config(str(pathlib.Path(__file__).resolve().parents[1] / "examples" / "qm9"
                          / "qm9.json"))
    cfg["Dataset"] = {"name": "probe", "node_features": cfg["Dataset"]["node_features"],
                      "graph_features": cfg["Dataset"]["graph_features"]}
    cfg["NeuralNetwork"]["Architecture"].update(arch)
    aug = update_config(cfg, [GraphSample(x=np.ones((29, 1)), graph_y=np.zeros(1))])
    model = create_model_config(aug, device=dev)
    return model, create_train_state(model, aug["NeuralNetwork"]["Training"]["Optimizer"])


def test_gin_train_step_launches_on_card(batch):
    """One train step of a 4-layer GIN: 4 forward and 3 backward
    gather-scatter launches (conv layer 0's input needs no gradient) and 1
    segment-sum launch (the pooling), and fp32 gradients for every
    parameter."""
    import pathlib

    from hydragnn_tpu_torch.config import load_config, update_config
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.train.step import create_train_state, make_train_step

    dev = _cuda_or_skip()
    cfg = load_config(str(pathlib.Path(__file__).resolve().parents[1] / "examples" / "qm9"
                          / "qm9.json"))
    cfg["Dataset"] = {"name": "probe", "node_features": cfg["Dataset"]["node_features"],
                      "graph_features": cfg["Dataset"]["graph_features"]}
    aug = update_config(cfg, [GraphSample(x=np.ones((3, 1)), graph_y=np.zeros(1))])
    model = create_model_config(aug, device=dev)
    state = create_train_state(model, aug["NeuralNetwork"]["Training"]["Optimizer"])
    step = make_train_step(torch.bfloat16)
    b = batch.replace(graph_y=torch.randn(batch.num_graphs, 1,
                                          generator=torch.Generator().manual_seed(0)))
    step(state, b.to(dev))  # warm-up (builds the kernels)
    fs.reset_launches()
    metrics = step(state, b.to(dev))
    torch.cuda.synchronize()
    assert fs.LAUNCHES == {"gather_scatter_sum": 4, "gather_scatter_sum_bwd": 3,
                           "segment_sum": 1, "segment_softmax": 0,
                           "segment_softmax_stats": 0, "segment_softmax_normalise": 0,
                           "masked_softmax": 0, "cell_list": 0, "quant_dense": 0,
                           "fp8_dense": 0}
    assert bool(torch.isfinite(metrics["loss"]))
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in model.parameters())


# -- the softmax kernels -------------------------------------------------------


def _gat_logits(b, heads, dtype, gen):
    """Logits over the batch's GAT layout (real edges, alignment slots on
    the dummy node, self loops), masked slots at -1e9, and its receivers."""
    senders, receivers = b.self_loop_edges()
    e_mask = torch.cat([b.edge_mask, b.edge_mask.new_zeros(senders.shape[0] - b.num_edges
                                                           - b.num_nodes),
                        b.edge_mask.new_ones(b.num_nodes)])
    x = torch.randn(senders.shape[0], heads, generator=gen).to(b.device) * 3.0
    x = torch.where(e_mask[:, None] > 0, x, -1e9)
    return x.to(dtype), receivers


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("layout", ["gat", "unsorted", "hubs", "empty_and_inf"])
def test_segment_softmax_kernel_matches_plain_on_card(batch, dtype, layout):
    """GAT's layout (its receivers are not sorted: the self loops come last;
    the dummy row owns every pad edge and alignment slot, several 32-entry
    pieces), a shuffled copy, rows of hundreds of entries onto 4 segments,
    and empty segments beside a segment of -inf logits; every row against
    the plain version, which the kernel matches on the dummy row too."""
    dev = _cuda_or_skip()
    gen = torch.Generator().manual_seed(11)
    b = batch.to(dev)
    n = b.num_nodes
    x, ids = _gat_logits(b, 6, dtype, gen)
    index = b.csr("loop_receivers") if layout == "gat" else None
    if layout == "gat":
        assert int(index.piece_ptr[n] - index.piece_ptr[n - 1]) > 1, "dummy row spans pieces"
    elif layout == "unsorted":
        p = torch.randperm(ids.shape[0], generator=gen).to(dev)
        x, ids = x[p], ids[p]
    elif layout == "hubs":
        ids = torch.sort(torch.randint(0, 4, ids.shape, generator=gen)).values.to(dev)
        ids = ids.to(torch.int32)
    else:
        ids = (ids // 2) * 2  # odd segments empty
        x = torch.where((ids == 10)[:, None], float("-inf"), x.float()).to(dtype)
    before = dict(fs.LAUNCHES)
    got = fsm.segment_softmax(x, ids, n, index=index)
    again = fsm.segment_softmax(x, ids, n, index=index)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["segment_softmax"] == before["segment_softmax"] + 2
    assert torch.equal(got, again), "two launches on the same inputs differ"
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    want = fsm.plain_segment_softmax(x, ids, n)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    if layout == "empty_and_inf":
        assert not got[ids == 10].any()


def test_segment_softmax_backward_on_card(batch):
    """ds = s * (dy - segment_sum(s * dy)[ids]): one segment-sum launch over
    the same CSR view, against the CPU route's gradient."""
    dev = _cuda_or_skip()
    gen = torch.Generator().manual_seed(12)
    b = batch.to(dev)
    x, ids = _gat_logits(b, 6, torch.float32, gen)
    dy = torch.randn(x.shape, generator=gen)
    x_dev = x.clone().requires_grad_()
    before = dict(fs.LAUNCHES)
    fsm.segment_softmax(x_dev, ids, b.num_nodes, index=b.csr("loop_receivers")).backward(
        dy.to(dev))
    torch.cuda.synchronize()
    assert fs.LAUNCHES["segment_sum"] == before["segment_sum"] + 1
    x_cpu = x.cpu().requires_grad_()
    fsm.segment_softmax(x_cpu, ids.cpu(), b.num_nodes).backward(dy)
    torch.testing.assert_close(x_dev.grad.cpu(), x_cpu.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("field", ["loop_senders", "loop_receivers"])
def test_gather_rows_backward_on_card(batch, field):
    """GAT's gathers onto the extended entries: the gradient is one
    segment-sum launch over the ids' CSR view (the dummy row's many
    pieces), bit-stable, and matches the CPU route's."""
    dev = _cuda_or_skip()
    b = batch.to(dev)
    ids = b.self_loop_edges()[0 if field == "loop_senders" else 1]
    gen = torch.Generator().manual_seed(15)
    x = torch.randn(b.num_nodes, 6, 8, generator=gen)
    dy = torch.randn(ids.shape[0], 6, 8, generator=gen)
    grads = []
    for _ in range(2):
        x_dev = x.to(dev).requires_grad_()
        before = dict(fs.LAUNCHES)
        fs.gather_rows(x_dev, ids, b.csr(field)).backward(dy.to(dev))
        torch.cuda.synchronize()
        assert fs.LAUNCHES["segment_sum"] == before["segment_sum"] + 1
        grads.append(x_dev.grad)
    assert torch.equal(grads[0], grads[1]), "two backward launches differ"
    x_cpu = x.clone().requires_grad_()
    fs.gather_rows(x_cpu, ids.cpu()).backward(dy)
    torch.testing.assert_close(grads[0][:-1].cpu(), x_cpu.grad[:-1], **TOL[torch.float32])


def _dense_logits(gen, dtype, g=65, heads=4, n_max=32):
    """GPS's dense blocks at the qm9.json top bucket's shape: 64 molecules of
    9-29 atoms and the empty dummy graph (fully masked rows)."""
    n_node = torch.randint(9, 30, (g,), generator=gen)
    n_node[-1] = 0
    valid = torch.arange(n_max)[None, :] < n_node[:, None]
    return torch.randn(g, heads, n_max, n_max, generator=gen).to(dtype) * 3.0, valid


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_masked_softmax_kernel_matches_plain_on_card(dtype):
    dev = _cuda_or_skip()
    x, valid = _dense_logits(torch.Generator().manual_seed(13), dtype)
    x, valid = x.to(dev), valid.to(dev)
    before = dict(fs.LAUNCHES)
    got = fsm.masked_softmax(x, valid)
    again = fsm.masked_softmax(x, valid)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["masked_softmax"] == before["masked_softmax"] + 2
    assert torch.equal(got, again) and got.dtype == dtype
    torch.testing.assert_close(got.float(), fsm.plain_masked_softmax(x, valid).float(),
                               **TOL[dtype])
    # the dummy graph's fully masked rows are uniform; masked entries of
    # real rows are exactly 0
    torch.testing.assert_close(got[-1].float(), torch.full_like(got[-1].float(), 1 / 32),
                               **TOL[dtype])
    masked = (~valid[:-1])[:, None, None, :].expand_as(got[:-1])
    assert not got[:-1][masked].any()
    with pytest.raises(ValueError, match="mask must be"):
        fsm.masked_softmax(x, valid[:, :-1])


def test_masked_softmax_backward_on_card():
    dev = _cuda_or_skip()
    gen = torch.Generator().manual_seed(14)
    x, valid = _dense_logits(gen, torch.float32)
    dy = torch.randn(x.shape, generator=gen)
    x_dev = x.to(dev).requires_grad_()
    fsm.masked_softmax(x_dev, valid.to(dev)).backward(dy.to(dev))
    x_cpu = x.clone().requires_grad_()
    fsm.masked_softmax(x_cpu, valid).backward(dy)
    torch.testing.assert_close(x_dev.grad.cpu(), x_cpu.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch,want", [
    ({"mpnn_type": "GAT"},
     {"gather_scatter_sum": 0, "gather_scatter_sum_bwd": 0, "segment_sum": 17,
      "segment_softmax": 4, "segment_softmax_stats": 0, "segment_softmax_normalise": 0,
      "masked_softmax": 0, "cell_list": 0, "quant_dense": 0, "fp8_dense": 0}),
    ({"global_attn_engine": "GPS", "global_attn_heads": 4, "pe_dim": 4,
      "max_graph_nodes": 32},
     {"gather_scatter_sum": 4, "gather_scatter_sum_bwd": 4, "segment_sum": 1,
      "segment_softmax": 0, "segment_softmax_stats": 0, "segment_softmax_normalise": 0,
      "masked_softmax": 4, "cell_list": 0, "quant_dense": 0, "fp8_dense": 0}),
    ({"global_attn_engine": "GPS", "global_attn_type": "performer", "global_attn_heads": 4,
      "pe_dim": 4, "max_graph_nodes": 32},
     {"gather_scatter_sum": 4, "gather_scatter_sum_bwd": 4, "segment_sum": 17,
      "segment_softmax": 0, "segment_softmax_stats": 0, "segment_softmax_normalise": 0,
      "masked_softmax": 0, "cell_list": 0, "quant_dense": 0, "fp8_dense": 0}),
], ids=["GAT", "GPS-GIN", "GPS-performer"])
def test_attention_train_step_launches_on_card(batch, arch, want):
    """One bf16 train step of the qm9.json GAT (4 softmaxes; 4 aggregations
    + 1 pooling forward, and 4 softmax backwards and 8 gather backwards, by
    sender and by receiver, on the segment-sum kernel)
    and GPS-GIN (4 + 4 gather-scatter: layer 0's input is the learned
    embedding; 4 masked softmaxes; 1 pooling); GPS-GIN with performer
    attention (the same gather-scatters; per layer the per-graph kv and z
    sums and their gathers' backward sums, and 1 pooling)."""
    from hydragnn_tpu_torch.preprocess.encodings import laplacian_pe
    from hydragnn_tpu_torch.train.step import make_train_step

    dev = _cuda_or_skip()
    model, state = _qm9_model(dev, **arch)
    pe = torch.zeros(batch.num_nodes, 4)
    ns = batch.n_node.tolist()
    start = 0
    for k in ns[:-1]:  # per-graph encodings of the path-graph stand-ins
        ids = np.arange(k - 1)
        pe[start:start + k] = torch.from_numpy(laplacian_pe(ids, ids + 1, k, 4))
        start += k
    b = batch.replace(graph_y=torch.randn(batch.num_graphs, 1,
                                          generator=torch.Generator().manual_seed(0)), pe=pe)
    step = make_train_step(torch.bfloat16)
    step(state, b.to(dev))  # warm-up (builds the kernels)
    fs.reset_launches()
    metrics = step(state, b.to(dev))
    torch.cuda.synchronize()
    assert fs.LAUNCHES == want
    assert bool(torch.isfinite(metrics["loss"]))


# -- kernel B5: the MD cell list --------------------------------------------------


def _cell_system(kind, n=1000, box=38.0, seed=21):
    """Positions in a cubic box (``lattice``: the MLIP MD cell's jittered
    simple-cubic lattice; else uniform), the pbc of ``kind`` and a plan."""
    from hydragnn_tpu_torch.md import plan_cell_grid

    rng = np.random.default_rng(seed)
    if kind == "lattice":
        k = round(n ** (1 / 3))
        g = np.stack(np.meshgrid(*([np.arange(k)] * 3), indexing="ij"), -1).reshape(-1, 3)
        a = box / k
        pos = g * a + rng.uniform(-0.05 * a, 0.05 * a, size=g.shape)
    else:
        pos = rng.uniform(0, box, size=(n, 3))
    pbc = {"slab": (True, True, False), "open": (False, False, False)}.get(kind, (True,) * 3)
    pbc = np.asarray(pbc)
    cell = np.eye(3, dtype=np.float32) * box
    return pos.astype(np.float32), cell, pbc, plan_cell_grid(cell, 5.0, n, pbc=pbc)


def _cell_build(dev, pos, cell, pbc, plan, max_edges, plain=False):
    from hydragnn_tpu_torch.ops import fused_cell_list as fcl

    args = (torch.from_numpy(pos).to(dev), 5.0, max_edges, torch.from_numpy(cell).to(dev),
            torch.from_numpy(pbc).to(dev), plan[0], plan[1])
    if not plain:
        return fcl.binned_radius_graph(*args, pad_id=pos.shape[0] - 1)
    saved = fcl._route
    fcl._route = lambda name, t: False
    try:
        return fcl.binned_radius_graph(*args, pad_id=pos.shape[0] - 1)
    finally:
        fcl._route = saved


@pytest.mark.parametrize("kind", ["lattice", "periodic", "slab", "open", "truncated"])
def test_cell_list_kernel_matches_plain_on_card(kind):
    """B5 against the plain version (the XLA build) on the same positions:
    ids, mask and n_edges identical, shifts within 1e-6; a truncated
    buffer keeps the same prefix; two launches bit-identical."""
    dev = _cuda_or_skip()
    pos, cell, pbc, plan = _cell_system("periodic" if kind == "truncated" else kind)
    max_edges = 2000 if kind == "truncated" else 16 * pos.shape[0]
    before = fs.LAUNCHES["cell_list"]
    got = _cell_build(dev, pos, cell, pbc, plan, max_edges)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["cell_list"] == before + 1
    want = _cell_build(dev, pos, cell, pbc, plan, max_edges, plain=True)
    for a, b in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert torch.equal(a, b)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-6)
    assert int(got[4]) > (max_edges if kind == "truncated" else 1000)
    again = _cell_build(dev, pos, cell, pbc, plan, max_edges)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_cell_list_overflow_and_empty_cells_on_card():
    """A capacity below the densest cell poisons n_edges as the plain
    version does; a half-empty box (every atom in x < box / 2) leaves
    cells empty and still matches; float64 positions raise."""
    from hydragnn_tpu_torch.md import plan_cell_grid

    dev = _cuda_or_skip()
    pos, cell, pbc, plan = _cell_system("periodic")
    tight = (plan[0], 2)
    got = _cell_build(dev, pos, cell, pbc, tight, 16000)
    want = _cell_build(dev, pos, cell, pbc, tight, 16000, plain=True)
    assert int(got[4]) == int(want[4]) > 16000
    half = pos.copy()
    half[:, 0] *= 0.5
    plan_h = plan_cell_grid(cell, 5.0, half.shape[0], pbc=pbc)
    got = _cell_build(dev, half, cell, pbc, plan_h, 32000)
    want = _cell_build(dev, half, cell, pbc, plan_h, 32000, plain=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(TypeError, match="float32"):
        _cell_build(dev, pos.astype(np.float64), cell, pbc, plan, 16000)


def _device_kernels(fn, reps=100):
    """``{name: launches per call}`` of the device operations of ``fn()``:
    ``chip_smoke.device_ops`` (the repository root is on the path when
    pytest runs as ``python -m pytest`` from it)."""
    import chip_smoke

    return {name: count for name, count, _ in chip_smoke.device_ops(torch, fn, reps)[2]}


def test_cell_list_is_one_launch_per_build_on_card():
    """The pair test is one kernel launch after one fill (no count launch,
    cumsum, subtract or sum between launches), and a whole build launches
    the cell-list kernel once."""
    from hydragnn_tpu_torch.ops import fused_cell_list as fcl

    dev = _cuda_or_skip()
    pos, cell, pbc, plan = _cell_system("lattice")
    p = torch.from_numpy(pos).to(dev)
    cellm, inv, pbcf = fcl.geometry(torch.from_numpy(cell).to(dev), torch.from_numpy(pbc).to(dev),
                                    p.dtype, dev)
    grid, cap = plan
    n_cells = grid[0] * grid[1] * grid[2]
    idx3, order, _, start, occ = fcl._prelude(p, cellm, inv, pbcf, grid, n_cells)
    ops = _device_kernels(lambda: fcl._kernel_cell_pairs(p, 5.0, 16000, cellm, inv, pbcf, grid,
                                                         cap, idx3, order, start, occ))
    assert sum(ops.values()) == 2, ops
    assert sum(c for n, c in ops.items() if "cell_list_kernel" in n) == 1, ops
    assert not any(w in n.lower() for n in ops for w in ("scan", "cumsum", "reduce")), ops
    build = _device_kernels(lambda: _cell_build(dev, pos, cell, pbc, plan, 16000), reps=20)
    assert sum(c for n, c in build.items() if "cell_list_kernel" in n) == 1, build


def test_cell_list_replays_under_a_cuda_graph_on_card():
    """A whole build captured in a CUDA graph, replayed twice, gives the
    eager build's ids, shifts, mask and n_edges each time: the look-back
    flags and the ticket start from zero at every replay."""
    from hydragnn_tpu_torch.ops import fused_cell_list as fcl

    dev = _cuda_or_skip()
    pos, cell, pbc, plan = _cell_system("periodic")
    p = torch.from_numpy(pos).to(dev)
    geo = fcl.geometry(torch.from_numpy(cell).to(dev), torch.from_numpy(pbc).to(dev), p.dtype, dev)

    def build():
        return fcl.cell_list_edges(p, 5.0, 16000, geo, plan[0], plan[1], pad_id=pos.shape[0] - 1)

    want = build()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        build()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = build()
    for _ in range(2):
        for o in out:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, want))


def _cluster_system(n=800, box=30.0, cluster=240, radius=2.0, seed=5):
    """A periodic box of uniform atoms with a dense cluster at its centre:
    every cluster atom has more neighbours within 5 A than the kernel's
    shared-memory hit cache holds, and the densest cell more atoms than a
    warp has lanes. The capacity is the densest cell's occupancy."""
    from hydragnn_tpu_torch.md import plan_cell_grid

    rng = np.random.default_rng(seed)
    u = rng.normal(size=(cluster, 3))
    u *= (radius * rng.uniform(0, 1, size=(cluster, 1)) ** (1 / 3)) / np.linalg.norm(u, axis=1,
                                                                                     keepdims=True)
    pos = np.concatenate([rng.uniform(0, box, size=(n - cluster, 3)), box / 2 + u]).astype(
        np.float32)
    cell = np.eye(3, dtype=np.float32) * box
    pbc = np.ones(3, bool)
    grid, _ = plan_cell_grid(cell, 5.0, n, pbc=pbc)
    g = np.asarray(grid)
    ids = np.minimum((pos / box * g).astype(int), g - 1)
    occ = np.bincount((ids[:, 0] * g[1] + ids[:, 1]) * g[2] + ids[:, 2])
    return pos, cell, pbc, (grid, int(occ.max()))


@pytest.mark.parametrize("truncate", [False, True], ids=["whole", "max_edges_below_count"])
def test_cell_list_hit_cache_overflow_on_card(truncate):
    """Atoms with more hits than the hit cache take the in-launch recompute
    path; cells hold more than 32 atoms (capacity above 32 slots); the
    edges equal the plain version's, whole and truncated below the true
    count (the prefix kept, n_edges the true count)."""
    dev = _cuda_or_skip()
    pos, cell, pbc, plan = _cluster_system()
    assert plan[1] > 32
    whole = _cell_build(dev, pos, cell, pbc, plan, 200000, plain=True)
    n_real = int(whole[4])
    s = whole[0][:n_real].cpu()
    assert int(torch.bincount(s).max()) > 64  # the kernel's cache holds 64 hits per atom
    max_edges = n_real // 2 if truncate else 200000
    got = _cell_build(dev, pos, cell, pbc, plan, max_edges)
    want = _cell_build(dev, pos, cell, pbc, plan, max_edges, plain=True)
    assert int(got[4]) == int(want[4]) == n_real
    for a, b in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert torch.equal(a, b)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["lattice", "periodic", "slab", "open", "cluster"])
def test_cell_list_shifts_are_bit_equal_on_card(kind):
    """The shifts the kernel writes are the plain epilogue's bits on every
    live slot (the same roundings, in the same order) and 0 elsewhere."""
    dev = _cuda_or_skip()
    if kind == "cluster":
        pos, cell, pbc, plan = _cluster_system()
    else:
        pos, cell, pbc, plan = _cell_system(kind)
    max_edges = 200000 if kind == "cluster" else 16 * pos.shape[0]
    got = _cell_build(dev, pos, cell, pbc, plan, max_edges)
    want = _cell_build(dev, pos, cell, pbc, plan, max_edges, plain=True)
    live = got[3] > 0
    assert int(live.sum()) > 0
    assert torch.equal(got[2][live].view(torch.int32), want[2][live].view(torch.int32))
    assert not bool(got[2][~live].any())


# -- the repaired backwards: second derivatives --------------------------------------


def _second_derivative(fn, xs, dy, v):
    xs = [x.clone().requires_grad_(True) for x in xs]
    dy = dy.clone().requires_grad_(True)
    grads = torch.autograd.grad(fn(*xs), xs, dy, create_graph=True)
    inner = sum((g * vi).sum() for g, vi in zip(grads, v))
    return torch.autograd.grad(inner, xs + [dy], allow_unused=True)


@pytest.mark.parametrize("op", ["fused_segment_sum", "gather_rows", "gather_scatter_sum",
                                "gather_scatter_sum_bwd", "segment_softmax"])
def test_second_derivatives_match_plain_on_card(batch, op):
    """The gradient of a gradient through each repaired Function (in its
    inputs and in the upstream gradient) on the card, with the kernels,
    against the CPU route's (the plain versions); the double backward
    launches kernels (a raw launcher in a backward would have dropped it)."""
    dev = _cuda_or_skip()
    b = batch.to(dev)
    n, e = b.num_nodes, b.num_edges
    gen = torch.Generator().manual_seed(31)
    mask = batch.edge_mask[:, None]
    real = (torch.arange(n) < n - 1).float()[:, None]
    x_sm, ids_sm = _gat_logits(b, 6, torch.float32, gen)
    cases = {
        "fused_segment_sum": (
            lambda d, x: fs.fused_segment_sum(x, d.receivers, n,
                                              index=d.csr("receivers") if x.is_cuda else None),
            [torch.randn(e, 16, generator=gen) * mask]),
        "gather_rows": (
            lambda d, x: fs.gather_rows(x, d.senders,
                                        d.csr("senders") if x.is_cuda else None),
            [torch.randn(n, 16, generator=gen) * real]),
        "gather_scatter_sum": (
            lambda d, h, w: fs.gather_scatter_sum(h, d.senders, d.receivers, n, weight=w),
            [torch.randn(n, 16, generator=gen) * real,
             torch.rand(e, generator=gen) * batch.edge_mask]),
        "gather_scatter_sum_bwd": (
            lambda d, g, w: fs.gather_scatter_sum_bwd(g, d.senders, d.receivers, n, weight=w),
            [torch.randn(n, 16, generator=gen) * real,
             torch.rand(e, generator=gen) * batch.edge_mask]),
        "segment_softmax": (lambda d, x: fsm.segment_softmax(x, ids_sm.to(x.device), n),
                            [x_sm.cpu()]),
    }
    fn, xs = cases[op]
    out_shape = fn(batch, *xs).shape
    dy = torch.randn(out_shape, generator=gen)
    v = [torch.randn(x.shape, generator=gen) for x in xs]
    before = sum(fs.LAUNCHES.values())
    got = _second_derivative(lambda *a: fn(b, *a), [x.to(dev) for x in xs], dy.to(dev),
                             [t.to(dev) for t in v])
    torch.cuda.synchronize()
    assert sum(fs.LAUNCHES.values()) > before
    want = _second_derivative(lambda *a: fn(batch, *a), xs, dy, v)
    for g, w in zip(got, want):
        if w is None:
            assert g is None or not bool(g.any())
            continue
        rows = slice(None) if g.shape[0] != n else slice(0, n - 1)
        torch.testing.assert_close(g[rows].cpu(), w[rows], rtol=1e-4, atol=1e-5)


# -- kernels 6 and 7: the int8 and fp8 dense layers --------------------------


# (M, K, N): qm9 GIN's conv layer 0 (K = 1) and its 64-wide layers at the top
# bucket's 1,864 rows, a head's output Dense (N = 1), GAT's 384 x 384
# lin_l (147 KB of weights in shared memory), a ragged row count, a K
# whose weights do not fit one CTA (the N-tiled grid), and a K not a
# multiple of 32 with an N not a multiple of 8 at a ragged row count, and
# K = 1 there (rows that are not 16-byte multiples are staged as one
# contiguous run of 16-byte vectors; a ragged tile ends in single values)
QUANT_SHAPES = [(1864, 1, 64), (1864, 64, 64), (64, 64, 1), (1864, 384, 384), (37, 24, 16),
                (40, 1200, 300), (37, 129, 9), (37, 1, 5)]
# edge features and GPS at the qm9 top bucket (E = 17,792, N = 1,864): GAT's
# lin_edge over the extended layout's 19,712 entries (K = 1, N = 384), GPS's
# rel_pos_emb (K = 4) and edge_lin (K = 128) over the edges; the
# performer's q/k/v/out are the 64 x 64 layers above
EDGE_QUANT_SHAPES = [(19712, 1, 384), (17792, 4, 64), (17792, 128, 64)]


def _ulp_close(got, want):
    """|got - want| <= one ulp of |want|, elementwise (fp32)."""
    ulp = torch.nextafter(want.abs(), torch.full_like(want, float("inf"))) - want.abs()
    return bool(((got - want).abs() <= ulp).all())


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", QUANT_SHAPES + EDGE_QUANT_SHAPES, ids=str)
def test_quant_dense_kernel_matches_plain_on_card(shape, dtype):
    """Codes and int32 accumulators equal, ``y`` within 1 ulp, two launches
    bit-identical, one launch counted per call, bias optional."""
    from hydragnn_tpu_torch.ops import quant_matmul as qm

    dev = _cuda_or_skip()
    m, k, n = shape
    gen = torch.Generator().manual_seed(7)
    x = (torch.randn(m, k, generator=gen) * 2).to(dev, dtype)
    w_q, s_w = qm.quantize_weight(torch.randn(k, n, generator=gen).to(dev))
    b = torch.randn(n, generator=gen).to(dev)
    s_x = float(x.float().abs().max()) / 127.0
    for bias in (b, None):
        before = fs.LAUNCHES["quant_dense"]
        x_q, acc, y = qm.quant_dense_parts(x, w_q, s_w, s_x, bias)
        torch.cuda.synchronize()
        assert fs.LAUNCHES["quant_dense"] == before + 1
        px_q, pacc, py = qm.reference_quant_parts(x, w_q, s_w, s_x, bias)
        assert torch.equal(x_q, px_q) and torch.equal(acc, pacc)
        assert _ulp_close(y, py)
        assert torch.equal(qm.quant_dense(x, w_q, s_w, s_x, bias), y)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        qm.quant_dense(x.half(), w_q, s_w, s_x)
    with pytest.raises(ValueError, match="all inputs must be on"):
        qm.quant_dense(x, w_q.cpu(), s_w, s_x)


def _quant_inputs(shape, dtype, dev, seed=7):
    from hydragnn_tpu_torch.ops import quant_matmul as qm

    m, k, n = shape
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(m, k, generator=gen) * 2).to(dev, dtype)
    w_q, s_w = qm.quantize_weight(torch.randn(k, n, generator=gen).to(dev))
    b = torch.randn(n, generator=gen).to(dev)
    return x, w_q, s_w, float(x.float().abs().max()) / 127.0, b


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_quant_dense_is_one_kernel_and_replays_under_a_cuda_graph(dtype):
    """One device operation per call under ``torch.profiler``, and a call
    captured in a CUDA graph replays to the eager bits."""
    from hydragnn_tpu_torch.ops import quant_matmul as qm

    dev = _cuda_or_skip()
    x, w_q, s_w, s_x, b = _quant_inputs((37, 129, 9), dtype, dev)
    ops = _device_kernels(lambda: qm.quant_dense(x, w_q, s_w, s_x, b))
    assert sum(ops.values()) == 1 and all("quant_mma_kernel" in n for n in ops), ops
    want = qm.quant_dense(x, w_q, s_w, s_x, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qm.quant_dense(x, w_q, s_w, s_x, b)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qm.quant_dense(x, w_q, s_w, s_x, b)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("shape", [(1864, 64, 64), (1864, 1, 64), (64, 64, 1), (25472, 129, 64),
                                   (37, 24, 16), (40, 1200, 300), (8461, 129, 9)], ids=str)
def test_fp8_dense_kernel_matches_plain_on_card(shape, fmt):
    """``x_q`` bit-equal, ``y`` within the summation-order bound, saturation
    without inf (an activation scale 1000x too small)."""
    from hydragnn_tpu_torch.ops import fp8_matmul as f8

    dev = _cuda_or_skip()
    m, k, n = shape
    gen = torch.Generator().manual_seed(8)
    x = (torch.randn(m, k, generator=gen) * 3).to(dev)
    w_q, s_w = f8.quantize_weight_fp8(torch.randn(k, n, generator=gen).to(dev), fmt)
    b = torch.randn(n, generator=gen).to(dev)
    for s_x in (f8.activation_scale_fp8(x, fmt), f8.activation_scale_fp8(x, fmt) / 1000):
        before = fs.LAUNCHES["fp8_dense"]
        x_q, y = f8.fp8_matmul_parts(x, w_q, s_w, s_x, b, fmt, debug=True)
        torch.cuda.synchronize()
        assert fs.LAUNCHES["fp8_dense"] == before + 1
        px_q, py = f8.reference_fp8_parts(x, w_q, s_w, s_x, b, fmt)
        assert torch.equal(x_q.view(torch.uint8), px_q.view(torch.uint8))
        mag = x_q.float().abs().double() @ w_q.float().abs().double()
        bound = (k * 2.0 ** -23 * mag * float(s_x) * s_w.double()[None, :]
                 + torch.nextafter(py.abs(), torch.full_like(py, float("inf"))).double()
                 - py.abs().double())
        assert bool(((y.double() - py.double()).abs() <= bound).all())
        assert bool(torch.isfinite(y).all())
    got = f8.certify_fp8_dense(x, w_q.float() * s_w, b, fmt)
    assert 0 < got["rel_fro_err"] < 0.2


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("shape", [(256, 64, 64), (256, 129, 64), (64, 1200, 300)], ids=str)
def test_fp8_dense_adversarial_accumulation_on_card(shape, fmt):
    """B7's fp32 sum on the tensor cores against the exact sum, on codes over
    the format's whole range whose sums cancel
    (``chip_smoke.fp8_adversarial_inputs``, ``s_x = 1``): the codes
    bit-equal and ``y`` within the summation-order bound of
    ``chip_smoke.fp8_bound_ratio``, the one ``check_fp8_dense`` holds."""
    import chip_smoke

    _cuda_or_skip()
    x, w = chip_smoke.fp8_adversarial_inputs(torch, fmt, *shape,
                                             torch.Generator().manual_seed(9))
    x, w = x.cuda(), w.cuda()
    codes, ratio, _, _, finite = chip_smoke.fp8_bound_ratio(
        torch, x, *chip_smoke.fp8_quantized(torch, x, w, fmt, 1.0), None, fmt)
    assert codes and finite
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_fp8_dense_is_one_kernel_and_replays_under_a_cuda_graph(fmt):
    """One device operation per call under ``torch.profiler`` (the weight is
    row-major, so nothing is copied), and a call captured in a CUDA graph
    replays to the eager bits."""
    from hydragnn_tpu_torch.ops import fp8_matmul as f8

    dev = _cuda_or_skip()
    gen = torch.Generator().manual_seed(10)
    x = (torch.randn(37, 129, generator=gen) * 3).to(dev)
    w_q, s_w = f8.quantize_weight_fp8(torch.randn(9, 129, generator=gen).to(dev).t(), fmt)
    s_x = f8.activation_scale_fp8(x, fmt)
    b = torch.randn(9, generator=gen).to(dev)

    def call():
        return f8.fp8_matmul_parts(x, w_q, s_w, s_x, b, fmt)[1]

    ops = _device_kernels(call)
    assert sum(ops.values()) == 1 and all("quant_mma_kernel" in n for n in ops), ops
    want = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.parametrize("arch", [{}, {"mpnn_type": "GAT"}], ids=["GIN", "GAT"])
def test_quantized_predict_step_on_card(batch, arch):
    """The qm9.json model's int8 predict step on the card: one quant_dense
    launch per Dense call, and the answers of the CPU route given the same
    scale and weight tables (the codes flip only where an fp32 activation
    lies within its last bits of a rounding tie)."""
    import copy

    from hydragnn_tpu_torch.serve import quant as sq

    dev = _cuda_or_skip()
    model, _ = _qm9_model(dev, **arch)
    model.eval()
    b = batch
    scales = sq.collect_activation_scales(model, [b], torch.float32)
    weights = sq.quantize_dense_weights(model, scales)
    step = sq.make_quantized_predict_step(model, scales, weights)
    before = fs.LAUNCHES["quant_dense"]
    got = step(b.to(dev))
    torch.cuda.synchronize()
    assert fs.LAUNCHES["quant_dense"] == before + len(scales)
    cpu_model = copy.deepcopy(model).to("cpu")
    cpu_weights = {k: tuple(None if t is None else t.cpu() for t in v) for k, v in weights.items()}
    want = sq.make_quantized_predict_step(cpu_model, scales, cpu_weights)(b)
    real = b.graph_mask > 0
    scale = float(want[0][real].abs().max())
    torch.testing.assert_close(got[0].cpu()[real], want[0][real], rtol=0, atol=1e-3 * scale)


# -- the CSR kernels' fixed order, and B4's widths and views ----------------------


def _csr_emulation():
    """``chip_smoke.csr_sum_emulation`` and ``_bits`` (the repository root is
    on the path when pytest runs as ``python -m pytest`` from it)."""
    import chip_smoke

    return chip_smoke.csr_sum_emulation, chip_smoke._bits


def _ragged_ids(gen, layout):
    """Segment ids into 40 rows: rows of exactly 1, 31, 32, 33, 64 and 65
    entries, empty rows, and a dummy last row of 9,605 entries (301
    pieces); ``unsorted`` shuffles them (the wrapper then argsorts)."""
    lens = torch.tensor([1, 0, 31, 32, 0, 33, 64, 65] + [int(v) for v in torch.randint(
        0, 40, (31,), generator=gen)] + [32 * 300 + 5])
    lens[10] = 0
    ids = torch.repeat_interleave(torch.arange(lens.shape[0]), lens).int()
    if layout == "unsorted":
        ids = ids[torch.randperm(ids.shape[0], generator=gen)]
    return ids, lens.shape[0]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("c", [1, 3, 6, 64, 384])
@pytest.mark.parametrize("layout", ["sorted", "unsorted"])
def test_segment_sum_is_bit_for_bit_on_card(dtype, c, layout):
    """B2 on rows of 32 and 33 entries, empty rows and a dummy row of 301
    pieces: rows of at most ``PIECE_EDGES`` entries bit-equal to the CPU
    plain version (one thread: ``index_add_`` adds in index order), every
    row bit-equal to the fixed-order emulation of pieces and chains; two
    launches bit-equal; one counted launch per call."""
    emulate, bits = _csr_emulation()
    dev = _cuda_or_skip()
    gen = torch.Generator().manual_seed(31)
    ids, rows = _ragged_ids(gen, layout)
    x = torch.randn(ids.shape[0], c, generator=gen).to(dtype)
    index = fs.segment_index(ids.to(dev), rows, is_sorted=layout == "sorted")
    before = fs.LAUNCHES["segment_sum"]
    got = fs.fused_segment_sum(x.to(dev), ids.to(dev), rows, index=index)
    again = fs.fused_segment_sum(x.to(dev), ids.to(dev), rows, index=index)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["segment_sum"] == before + 2
    assert torch.equal(bits(torch, got), bits(torch, again))
    got = got.cpu()
    counts = torch.bincount(ids.long(), minlength=rows)
    single = counts <= fs.PIECE_EDGES
    plain = fs.plain_segment_sum(x, ids, rows)
    assert torch.equal(bits(torch, got)[single], bits(torch, plain)[single])
    emu = emulate(torch, x.float(), ids, rows).to(dtype)
    assert torch.equal(bits(torch, got), bits(torch, emu))
    assert not got[counts == 0].any()


@pytest.mark.parametrize("wkind", ["none", "edge", "channel"])
def test_gather_scatter_is_bit_for_bit_on_card(wkind):
    """B1 over the same ragged rows (senders random), forward and the
    transposed launch: every row bit-equal to the fixed-order emulation of
    the fp32 products ``h[s] * w``."""
    emulate, bits = _csr_emulation()
    dev = _cuda_or_skip()
    gen = torch.Generator().manual_seed(32)
    recv, n = _ragged_ids(gen, "unsorted")
    send = torch.randint(0, n, recv.shape, generator=gen).int()
    h = torch.randn(n, 64, generator=gen)
    w = (None if wkind == "none" else torch.rand(recv.shape[0], generator=gen)
         if wkind == "edge" else torch.rand(recv.shape[0], 64, generator=gen))
    wf = None if w is None else (w if w.dim() == 2 else w[:, None])
    w_d = None if w is None else w.to(dev)
    for src, dst, run in (
            (send, recv, lambda: fs.gather_scatter_sum(h.to(dev), send.to(dev), recv.to(dev),
                                                       n, weight=w_d)),
            (recv, send, lambda: fs.gather_scatter_sum_bwd(h.to(dev), send.to(dev),
                                                           recv.to(dev), n, w_d))):
        terms = h[src.long()] if wf is None else h[src.long()] * wf
        got = run().cpu()
        assert torch.equal(bits(torch, got), bits(torch, emulate(torch, terms, dst, n)))


@pytest.fixture(scope="module")
def triplet_batch():
    """The 16 molecules of ``batch`` with DimeNet's triplets attached (an
    ``idx_ji`` collate certifies sorted, an ``idx_kj`` it does not)."""
    from hydragnn_tpu_torch.graphs.triplets import attach_triplets

    rng = np.random.default_rng(3)
    samples = []
    for _ in range(16):
        na = int(rng.integers(9, 30))
        pos = rng.uniform(0, 6.0, size=(na, 3))
        s, r, sh = radius_graph(pos, radius=3.0, max_neighbours=20)
        samples.append(attach_triplets(GraphSample(x=rng.normal(size=(na, 1)), pos=pos,
                                                   senders=s, receivers=r, edge_shifts=sh)))
    return collate(samples, compute_pad_spec(samples, 16))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_triplet_mixing_is_bit_for_bit_on_card(triplet_batch, dtype):
    """B1 in weight mode 2 over DimeNet's triplets (``x_kj [E, 64]`` by
    ``idx_kj``, a weight per triplet and channel, onto ``idx_ji``'s E rows
    over its certified view) and the transposed launch over ``idx_kj``'s
    view: every row bit-equal to the fixed-order emulation; in fp32 the
    forward, ``dh`` and ``dw`` bit-equal to ``gather_rows`` + B2 over the
    same views."""
    emulate, bits = _csr_emulation()
    dev = _cuda_or_skip()
    b = triplet_batch.to(dev)
    assert b.meta.ji_sorted and b.csr("idx_ji").perm is None
    e, t = b.num_edges, b.idx_kj.shape[0]
    gen = torch.Generator().manual_seed(34)
    kj, ji = b.idx_kj.cpu(), b.idx_ji.cpu()
    h = torch.randn(e, 64, generator=gen).to(dtype)
    w = (torch.randn(t, 64, generator=gen) * b.triplet_mask.cpu()[:, None]).to(dtype)
    ji_idx, kj_idx = b.csr("idx_ji"), b.csr("idx_kj")
    got = fs.gather_scatter_sum(h.to(dev), b.idx_kj, b.idx_ji, e, weight=w.to(dev),
                                index=ji_idx, send_index=kj_idx).cpu()
    want = emulate(torch, h.float()[kj.long()] * w.float(), ji, e).to(dtype)
    assert torch.equal(bits(torch, got), bits(torch, want))
    got = fs.gather_scatter_sum_bwd(h.to(dev), b.idx_kj, b.idx_ji, e, w.to(dev),
                                    send_index=kj_idx, index=ji_idx).cpu()
    want = emulate(torch, h.float()[ji.long()] * w.float(), kj, e).to(dtype)
    assert torch.equal(bits(torch, got), bits(torch, want))
    if dtype != torch.float32:
        return
    hd = h.to(dev).requires_grad_()
    wd = w.to(dev).requires_grad_()
    dout = torch.randn(e, 64, generator=gen).to(dev)
    out_k = fs.gather_scatter_sum(hd, b.idx_kj, b.idx_ji, e, weight=wd, index=ji_idx,
                                  send_index=kj_idx)
    grads_k = torch.autograd.grad(out_k, (hd, wd), dout)
    out_g = fs.fused_segment_sum(fs.gather_rows(hd, b.idx_kj, kj_idx) * wd, b.idx_ji, e,
                                 index=ji_idx)
    grads_g = torch.autograd.grad(out_g, (hd, wd), dout)
    assert torch.equal(out_k, out_g)
    assert all(torch.equal(x, y) for x, y in zip(grads_k, grads_g))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("ids_name", ["senders", "receivers"])
def test_flattened_3d_segment_sum_is_bit_for_bit_on_card(batch, dtype, ids_name):
    """B2 over ``[E, 3, 32]`` vector messages (PAINN's and PNAEq's at the
    senders, MACE's ``l = 1`` block at the receivers), flattened to ``[E,
    96]`` by ``graphs.segment.segment_sum``: the ``[N, 3, 32]`` result
    bit-equal to the fixed-order emulation, one launch."""
    from hydragnn_tpu_torch.graphs import segment

    emulate, bits = _csr_emulation()
    dev = _cuda_or_skip()
    b = batch.to(dev)
    n, e = b.num_nodes, b.num_edges
    ids = getattr(b, ids_name)
    x = torch.randn(e, 3, 32, generator=torch.Generator().manual_seed(35)).to(dtype)
    before = fs.LAUNCHES["segment_sum"]
    got = segment.segment_sum(x.to(dev), ids, n, index=b.csr(ids_name))
    torch.cuda.synchronize()
    assert fs.LAUNCHES["segment_sum"] == before + 1
    assert got.shape == (n, 3, 32) and got.dtype == dtype
    want = emulate(torch, x.reshape(e, 96).float(), ids.cpu(), n).to(dtype).reshape(n, 3, 32)
    assert torch.equal(bits(torch, got.cpu()), bits(torch, want))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", ["performer_kv", "performer_z", "gat_self_loop_mean"])
def test_edge_and_performer_sums_are_bit_for_bit_on_card(batch, dtype, case):
    """B2 at the shapes edge features and the performer give it: the
    performer's per-graph ``kv`` ``[N, 4 * 16 * 16]`` and ``z`` ``[N, 4 * 16]``
    by graph, GAT's self-loop mean ``[E, 1]`` by receiver; bit-equal to the
    fixed-order emulation on every row and to the CPU plain version on rows
    of at most ``PIECE_EDGES`` entries, one launch each."""
    emulate, bits = _csr_emulation()
    dev = _cuda_or_skip()
    b = batch.to(dev)
    ids, rows, field, c = {"performer_kv": (b.batch, b.num_graphs, "batch", 1024),
                           "performer_z": (b.batch, b.num_graphs, "batch", 64),
                           "gat_self_loop_mean": (b.receivers, b.num_nodes, "receivers", 1)}[case]
    x = torch.randn(ids.shape[0], c, generator=torch.Generator().manual_seed(37)).to(dtype)
    before = fs.LAUNCHES["segment_sum"]
    got = fs.fused_segment_sum(x.to(dev), ids, rows, index=b.csr(field))
    torch.cuda.synchronize()
    assert fs.LAUNCHES["segment_sum"] == before + 1
    got = got.cpu()
    ids = ids.cpu()
    single = torch.bincount(ids.long(), minlength=rows) <= fs.PIECE_EDGES
    assert torch.equal(bits(torch, got)[single], bits(torch, fs.plain_segment_sum(x, ids, rows))[
        single])
    assert torch.equal(bits(torch, got), bits(torch, emulate(torch, x.float(), ids, rows).to(dtype)))


def test_segment_sum_is_one_launch_and_replays_under_a_cuda_graph():
    """One device kernel per wrapper call, and a CUDA graph of two calls over
    rows of many pieces replayed twice gives the eager bits each time (the
    per-row tickets that elect a row's combiner are back at 0 after every
    launch)."""
    _, bits = _csr_emulation()
    dev = _cuda_or_skip()
    gen = torch.Generator().manual_seed(33)
    ids, rows = _ragged_ids(gen, "sorted")
    ids = ids.to(dev)
    index = fs.segment_index(ids, rows, is_sorted=True)
    x = torch.randn(ids.shape[0], 64, generator=gen).to(dev)
    y = torch.randn(ids.shape[0], 6, generator=gen).to(dev)
    want = (fs.fused_segment_sum(x, ids, rows, index=index),
            fs.fused_segment_sum(y, ids, rows, index=index))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fs.fused_segment_sum(x, ids, rows, index=index)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if "csr_" in e.key]
    assert sum(e.count for e in kernels) == 1, [(e.key, e.count) for e in kernels]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fs.fused_segment_sum(x, ids, rows, index=index)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = fs.LAUNCHES["segment_sum"]
    with torch.cuda.graph(graph):
        out = (fs.fused_segment_sum(x, ids, rows, index=index),
               fs.fused_segment_sum(y, ids, rows, index=index))
    assert fs.LAUNCHES["segment_sum"] == before + 2
    for _ in range(2):
        for o in out:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(bits(torch, o), bits(torch, w)) for o, w in zip(out, want))
    assert fs.LAUNCHES["segment_sum"] == before + 2


def _softmax_inputs(gen, layout, heads, dtype):
    """``_ragged_ids``' rows (one piece: 1, 31, 32 entries; several: 33, 64,
    65 and a dummy row of 301 pieces; empty rows) with random logits, and
    the rows of 31 and 33 entries all -inf."""
    ids, rows = _ragged_ids(gen, layout)
    x = torch.randn(ids.shape[0], heads, generator=gen) * 3.0
    x[(ids == 2) | (ids == 5)] = float("-inf")
    return x.to(dtype), ids, rows


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("heads", [1, 6, 11])
@pytest.mark.parametrize("layout", ["sorted", "unsorted"])
def test_segment_softmax_is_bit_for_bit_on_card(dtype, heads, layout):
    """B3 on rows of exactly one piece and of several, empty rows and all
    -inf rows (one and two pieces), at one head, GAT's 6 (two heads per
    load) and 11 (two chunks of heads): every entry bit-equal to
    ``chip_smoke.segment_softmax_emulation``, the -inf rows 0, within the
    plain version's tolerance, two launches bit-equal, one counted launch
    per call."""
    import chip_smoke

    _, bits = _csr_emulation()
    dev = _cuda_or_skip()
    x, ids, rows = _softmax_inputs(torch.Generator().manual_seed(34), layout, heads, dtype)
    x, ids = x.to(dev), ids.to(dev)
    index = fs.segment_index(ids, rows, is_sorted=layout == "sorted")
    before = fs.LAUNCHES["segment_softmax"]
    got = fsm.segment_softmax(x, ids, rows, index=index)
    again = fsm.segment_softmax(x, ids, rows, index=index)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["segment_softmax"] == before + 2
    assert torch.equal(bits(torch, got), bits(torch, again))
    emu = chip_smoke.segment_softmax_emulation(torch, x, ids, rows)
    assert torch.equal(bits(torch, got), bits(torch, emu))
    assert not got[(ids == 2) | (ids == 5)].any()
    torch.testing.assert_close(got.float(), fsm.plain_segment_softmax(x, ids, rows).float(),
                               **TOL[dtype])
    assert not index.tickets.any()


def test_segment_softmax_launches_and_graph_replays_on_card():
    """A call is two device operations (the piece kernel and the second
    launch over the rows of several pieces) under ``torch.profiler``; a CUDA
    graph of an fp32 and a bf16 call over rows of many pieces, replayed
    twice, gives the eager bits each time, with the per-row tickets back at
    0 and no launch counted by a replay."""
    _, bits = _csr_emulation()
    dev = _cuda_or_skip()
    gen = torch.Generator().manual_seed(35)
    x, ids, rows = _softmax_inputs(gen, "sorted", 6, torch.float32)
    x, ids = x.to(dev), ids.to(dev)
    x16 = x.to(torch.bfloat16)
    index = fs.segment_index(ids, rows, is_sorted=True)

    def call():
        return (fsm.segment_softmax(x, ids, rows, index=index),
                fsm.segment_softmax(x16, ids, rows, index=index))

    ops = _device_kernels(lambda: fsm.segment_softmax(x, ids, rows, index=index))
    assert sum(ops.values()) == 2, ops
    assert sum(c for n, c in ops.items() if "segment_softmax_kernel" in n) == 1, ops
    assert sum(c for n, c in ops.items() if "softmax_normalise_kernel" in n) == 1, ops
    want = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = fs.LAUNCHES["segment_softmax"]
    with torch.cuda.graph(graph):
        out = call()
    assert fs.LAUNCHES["segment_softmax"] == before + 2
    for _ in range(2):
        for o in out:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(bits(torch, o), bits(torch, w)) for o, w in zip(out, want))
        assert not index.tickets.any()
    assert fs.LAUNCHES["segment_softmax"] == before + 2


def _split_layouts(dev, where: str):
    """GAT's extended layouts ``[(logits, receivers, index)]`` of ``where``:
    the qm9 top bucket of GAT and of GAT-edge (``chip_smoke``'s kinds; one
    rank), or the BCC supercell of ``chip_smoke --parallel`` as four edge
    shards (each rank's share of the layout, ``edge_share`` and
    ``self_loop_edges((4, r))``), with random logits, masked slots at -1e9
    and the rank-1 shard's statistics included."""
    import chip_smoke
    from hydragnn_tpu_torch.graphs.graph import loop_tail_mask
    from hydragnn_tpu_torch.parallel import large_graph as lg

    gen = torch.Generator().manual_seed(61)
    if where == "supercell_shards":
        sample = chip_smoke.supercell_samples(1, 1)
        host = collate(sample, compute_pad_spec(sample, 1))
        shards = [((4, r), lg.edge_share(host, 4, r, dev)) for r in range(4)]
    else:
        _, top, _ = chip_smoke._top_batch("gat" if where == "qm9_top_gat" else "gat_edge", 0)
        shards = [(None, top.to(dev))]
    out = []
    for shard, b in shards:
        _, recv = b.self_loop_edges(shard)
        tail = (loop_tail_mask(b.num_edges, b.num_nodes, *shard, device=dev) if shard
                else torch.cat([b.edge_mask.new_zeros(recv.shape[0] - b.num_edges
                                                      - b.num_nodes),
                                b.edge_mask.new_ones(b.num_nodes)]))
        valid = torch.cat([b.edge_mask, tail.to(b.edge_mask.dtype)])
        x = torch.randn(recv.shape[0], 6, generator=gen).to(dev) * 3.0
        out.append((torch.where(valid[:, None] > 0, x, -1e9), recv,
                    b.csr("loop_receivers", shard), b.num_nodes))
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("where", ["qm9_top_gat", "qm9_top_gat_edge"])
def test_split_segment_softmax_at_one_rank_is_b3_bit_for_bit_on_card(dtype, where):
    """B3's split form at one rank: ``segment_softmax_stats``, the combine
    of one rank's statistics, ``segment_softmax_normalise``: every entry
    bit-equal to the fused B3 at the qm9 top bucket of GAT and GAT-edge;
    one counted launch per entry; the statistics against their plain
    version within TOL (the maxima exactly)."""
    dev = _cuda_or_skip()
    ((x, ids, index, n),) = _split_layouts(dev, where)
    x = x.to(dtype)
    before = dict(fs.LAUNCHES)
    m, s = fsm.segment_softmax_stats(x, ids, n, index=index)
    shift, denom = fsm.combine_softmax_stats(m, s)
    got = fsm.segment_softmax_normalise(x, ids, n, shift, denom, index=index)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["segment_softmax_stats"] == before["segment_softmax_stats"] + 1
    assert fs.LAUNCHES["segment_softmax_normalise"] == before["segment_softmax_normalise"] + 1
    fused = fsm.segment_softmax(x, ids, n, index=index)
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       fused.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    pm, ps = fsm.plain_segment_softmax_stats(x, ids, n)
    assert torch.equal(m, pm)
    torch.testing.assert_close(s, ps, **TOL[torch.float32])
    assert not index.tickets.any()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_split_segment_softmax_at_supercell_shards_of_four_on_card(dtype):
    """B3's split form at the four edge shards of ``chip_smoke --parallel``'s
    supercell: each shard's statistics and normalisation against their
    plain versions within TOL, and the four shards' outputs, normalised
    from the statistics combined over the shards, against the plain
    one-device softmax of the whole layout (rows split so that most ranks
    hold none of a row's entries)."""
    dev = _cuda_or_skip()
    shards = _split_layouts(dev, "supercell_shards")
    stats, plain = [], []
    for x, ids, index, n in shards:
        x = x.to(dtype)
        m, s = fsm.segment_softmax_stats(x, ids, n, index=index)
        pm, ps = fsm.plain_segment_softmax_stats(x, ids, n)
        assert torch.equal(m, pm)
        torch.testing.assert_close(s, ps, **TOL[torch.float32])
        stats.append((m, s))
        plain.append((pm, ps))
    ms = torch.stack([m for m, _ in stats])
    m_all = ms.amax(0)
    shift, denom = fsm.combine_softmax_stats(
        ms, torch.stack([s for _, s in stats]), lambda t: t.amax(0), lambda t: t.sum(0))
    got, want = [], []
    for (x, ids, index, n) in shards:
        x = x.to(dtype)
        out = fsm.segment_softmax_normalise(x, ids, n, shift, denom, index=index)
        torch.testing.assert_close(
            out.float(), fsm.plain_segment_softmax_normalise(x, ids, shift, denom).float(),
            **TOL[dtype])
        got.append(out)
        want.append(x)
    assert bool(torch.isfinite(m_all).any())
    # the whole layout on one device: the shards' entries one after another
    x_all = torch.cat(want)
    ids_all = torch.cat([ids for _, ids, _, _ in shards])
    n = shards[0][3]
    ref = fsm.plain_segment_softmax(x_all, ids_all, n)
    real = ids_all != n - 1
    torch.testing.assert_close(torch.cat(got)[real].float(), ref[real].float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("m", [1, 5, 31, 32, 33, 64])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "view+1"])
def test_masked_softmax_widths_and_views_on_card(dtype, m, offset):
    """B4 at widths GPS's ``max_graph_nodes`` can take and on a view that
    starts one element past an aligned address: within the plain version's
    tolerance, masked entries of rows with a valid entry exactly 0, fully
    masked rows uniform, two launches bit-equal, and bit-equal to the same
    logits copied to an aligned tensor."""
    dev = _cuda_or_skip()
    gen = torch.Generator().manual_seed(40 + m)
    g, heads = 65, 4
    lens = torch.randint(0, m + 1, (g,), generator=gen)
    lens[0], lens[-1] = m, 0
    valid = (torch.arange(m)[None, :] < lens[:, None]).to(dev)
    flat = (torch.randn(g * heads * m * m + offset, generator=gen) * 3.0).to(dev, dtype)
    x = flat[offset:].view(g, heads, m, m)
    got = fsm.masked_softmax(x, valid)
    again = fsm.masked_softmax(x, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    # the kernel's two paths (vectorised where m and the alignment allow)
    # add in one order: a misaligned view and its aligned copy agree bit for bit
    assert torch.equal(got, fsm.masked_softmax(x.clone(), valid))
    torch.testing.assert_close(got.float(), fsm.plain_masked_softmax(x, valid).float(),
                               **TOL[dtype])
    live = valid.any(dim=1)
    assert not got[live][(~valid[live])[:, None, None, :].expand_as(got[live])].any()
    torch.testing.assert_close(got[~live].float(),
                               torch.full_like(got[~live].float(), 1 / m), **TOL[dtype])


@pytest.mark.parametrize("where", ["fixture", "qm9_top_bucket"])
def test_gat_backward_op_by_op_against_fp64_on_card(batch, where):
    """Bisect the card's fp32 GAT gradients, which miss an fp64 step by far
    more than the CPU's do (``chip_smoke.py``'s fp32 step check): the qm9.json
    GAT (dropout 0) runs one fp64 train-mode forward and loss on the CPU;
    every GATConv layer's input and the loss's gradient at its output are
    kept. Each op of each layer's forward then gets its fp64 inputs (cast to
    fp32) and the fp64 chain's gradient of its output, and its fp32 input
    gradients on the card and on the CPU are held against the same op in
    fp64. Then the whole model's fp32 parameter gradients, card and CPU,
    against the fp64 ones. Prints each op's and the worst tensors' errors,
    max |g32 - g64| / max |g64|, and the worst op; gates that every gradient
    is finite. ``where``: the 16-molecule fixture batch, or the top pad
    bucket of ``chip_smoke.py``'s qm9-like data (N = 1864, ~11.5k entries
    on the dummy node), where its fp32 step check reads the card's largest
    errors."""
    import copy

    import torch.nn.functional as F

    from hydragnn_tpu_torch.graphs import segment
    from hydragnn_tpu_torch.models.gat import GATConv
    from hydragnn_tpu_torch.train.step import cast_forward

    dev = _cuda_or_skip()
    model, _ = _qm9_model(dev, mpnn_type="GAT", dropout=0.0)
    gen = torch.Generator().manual_seed(50)
    # a copy of the batch: its CSR cache starts empty, not with an earlier
    # test's inference-mode tensors
    if where == "fixture":
        b64 = batch.replace(graph_y=torch.randn(batch.num_graphs, 1, generator=gen))
    else:
        import chip_smoke

        b64, _ = chip_smoke.bucket_batches(*chip_smoke.prepare(0)[2:])
    n, heads = b64.num_nodes, 6

    def grads_of(m, b, dtype):
        """The model's parameter gradients of one train-mode loss."""
        m.zero_grad()
        tot, _ = m.loss(cast_forward(m, b, dtype, train=True), b)
        tot.backward()
        return {k: p.grad.double().cpu() for k, p in m.named_parameters()}

    # the fp64 chain: every GATConv's and every feature norm's input and its
    # output's gradient
    ref = copy.deepcopy(model).cpu().double()
    convs = [m for m in ref.modules() if isinstance(m, GATConv)]
    norms = list(ref.feature_layers)
    seen = {}

    def keep(mod):
        def hook(module, args, output):
            out = output[0] if isinstance(output, tuple) else output
            seen[mod] = {"inv": args[0].detach()}
            out.register_hook(lambda g: seen[mod].__setitem__("dout", g.detach()))
        return hook

    handles = [c.register_forward_hook(keep(c)) for c in convs + norms]
    g64 = grads_of(ref, b64.map_floats(lambda t: t.double()), torch.float64)
    for h in handles:
        h.remove()

    def context(b):
        senders, receivers = b.self_loop_edges()
        mask = b.edge_mask
        sl_pad = senders.shape[0] - b.num_edges - n
        on_card = senders.is_cuda
        return dict(s=senders, r=receivers,
                    e_mask=torch.cat([mask, mask.new_zeros(sl_pad), mask.new_ones(n)]),
                    index=b.csr("loop_receivers") if on_card else None,
                    send_index=b.csr("loop_senders") if on_card else None)

    def ops(f, concat):  # (name, inputs, fn(ctx, *inputs), output), GATConv.forward's order
        return [
            ("lin_l (F.linear)", ("inv", "W_l", "b_l"),
             lambda c, x, w, bb: F.linear(x, w, bb).reshape(n, heads, f), "x_l"),
            ("lin_r (F.linear)", ("inv", "W_r", "b_r"),
             lambda c, x, w, bb: F.linear(x, w, bb).reshape(n, heads, f), "x_r"),
            ("gather_rows(x_l, senders)", ("x_l",),
             lambda c, x: fs.gather_rows(x, c["s"], c["send_index"]), "x_ls"),
            ("gather_rows(x_r, receivers)", ("x_r",),
             lambda c, x: fs.gather_rows(x, c["r"], c["index"]), "x_rr"),
            ("z = x_ls + x_rr", ("x_ls", "x_rr"), lambda c, a, b_: a + b_, "z"),
            ("leaky ReLU (torch.where)", ("z",),
             lambda c, z: torch.where(z >= 0, z, 0.05 * z), "z2"),
            ("einsum('ehf,hf->eh')", ("z2", "att"),
             lambda c, z, a: torch.einsum("ehf,hf->eh", z, a), "logits"),
            ("mask (torch.where)", ("logits",),
             lambda c, x: torch.where(c["e_mask"][:, None] > 0, x, -1e9), "logits_m"),
            ("segment_softmax", ("logits_m",),
             lambda c, x: segment.segment_softmax(x, c["r"], n, index=c["index"]), "alpha"),
            ("alpha * e_mask", ("alpha",), lambda c, a: a * c["e_mask"][:, None], "alpha_m"),
            ("msg = x_ls * alpha", ("x_ls", "alpha_m"), lambda c, x, a: x * a[:, :, None],
             "msg"),
            ("segment_sum(msg)", ("msg",),
             lambda c, m: segment.segment_sum(m, c["r"], n, index=c["index"]), "agg"),
            ("heads: concat" if concat else "heads: mean", ("agg",),
             (lambda c, a: a.reshape(n, heads * f)) if concat else (lambda c, a: a.mean(dim=1)),
             "out"),
        ]

    ctx64, ctx_card = context(b64), context(b64.to(dev))
    report = []
    for layer, conv in enumerate(convs):
        chain = ops(conv.hidden, conv.concat)
        vals = {"inv": seen[conv]["inv"].clone().requires_grad_(),
                "W_l": conv.lin_l.weight.detach().clone().requires_grad_(),
                "b_l": conv.lin_l.bias.detach().clone().requires_grad_(),
                "W_r": conv.lin_r.weight.detach().clone().requires_grad_(),
                "b_r": conv.lin_r.bias.detach().clone().requires_grad_(),
                "att": conv.att.detach().clone().requires_grad_()}
        for _, names, fn, out in chain:
            vals[out] = fn(ctx64, *(vals[k] for k in names))
            vals[out].retain_grad()
        vals["out"].backward(seen[conv]["dout"])
        upstream = {k: v.grad.detach() for k, v in vals.items() if v.grad is not None}

        def op_grads(c, names, fn, out, device, dtype):
            xs = [vals[k].detach().to(device, dtype).requires_grad_() for k in names]
            y = fn(c, *xs)
            return [g.double().cpu() for g in torch.autograd.grad(
                y, xs, upstream[out].to(device, dtype))]

        for name, names, fn, out in chain:
            want = op_grads(ctx64, names, fn, out, "cpu", torch.float64)
            errs = {}
            for route, c, device in (("card", ctx_card, dev), ("cpu", ctx64, "cpu")):
                got = op_grads(c, names, fn, out, device, torch.float32)
                assert all(bool(torch.isfinite(g).all()) for g in got), (layer, name, route)
                errs[route] = max(float((g - r).abs().max()) / max(float(r.abs().max()), 1e-300)
                                  for g, r in zip(got, want))
            report.append((f"layer {layer} {name}", errs["card"], errs["cpu"]))
    # the feature norms (MaskedBatchNorm, train mode: batch statistics over
    # the real rows) between the conv layers, the same way
    mask = b64.node_mask
    for layer, norm in enumerate(norms):
        x64, dy64 = seen[norm]["inv"], seen[norm]["dout"]

        def norm_grads(device, dtype):
            m = copy.deepcopy(norm).to(device, dtype)
            xs = [x64.to(device, dtype).requires_grad_(),
                  m.scale.detach().clone().requires_grad_(),
                  m.bias.detach().clone().requires_grad_()]
            y = torch.func.functional_call(m, {"scale": xs[1], "bias": xs[2]},
                                           (xs[0], mask.to(device, dtype), True))
            return [g.double().cpu() for g in torch.autograd.grad(y, xs, dy64.to(device, dtype))]

        want = norm_grads("cpu", torch.float64)
        errs = {route: max(float((g - r).abs().max()) / max(float(r.abs().max()), 1e-300)
                           for g, r in zip(norm_grads(device, torch.float32), want))
                for route, device in (("card", dev), ("cpu", "cpu"))}
        report.append((f"layer {layer} MaskedBatchNorm (train)", errs["card"], errs["cpu"]))
    print(f"\nqm9.json GAT on the {where} batch (N = {n}), each GATConv op's fp32 input "
          "gradients against the same op in fp64 (max |g32 - g64| / max |g64|), with the fp64 "
          "chain's inputs and output gradient:")
    for name, card, cpu in report:
        print(f"  {name:40s} card {card:.3e}   cpu {cpu:.3e}")
    worst = max(report, key=lambda r: r[1])
    print(f"worst op on the card: {worst[0]} ({worst[1]:.3e}; the CPU's {worst[2]:.3e})")

    # the whole model's fp32 gradients, card and CPU, against fp64
    g_card = grads_of(model, b64.to(dev), torch.float32)
    g_cpu = grads_of(copy.deepcopy(model).cpu(), b64, torch.float32)
    rel = {k: (float((g_card[k] - r).abs().max()) / max(float(r.abs().max()), 1e-300),
               float((g_cpu[k] - r).abs().max()) / max(float(r.abs().max()), 1e-300))
           for k, r in g64.items()}
    assert all(bool(torch.isfinite(g).all()) for g in g_card.values())
    print("the whole model's fp32 parameter gradients against fp64, the five worst on the "
          "card:")
    for k in sorted(rel, key=lambda k: -rel[k][0])[:5]:
        print(f"  {k:40s} card {rel[k][0]:.3e}   cpu {rel[k][1]:.3e}")
