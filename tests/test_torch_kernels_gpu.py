"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is ``gpu``-marked and skips without a CUDA device.

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
                           "segment_sum": 1}
    assert bool(torch.isfinite(metrics["loss"]))
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in model.parameters())
