"""The port's segment-reduction ops (``hydragnn_tpu_torch.ops.fused_scatter``)
against the JAX package's Pallas kernels and XLA references.

On the CPU the port's wrappers take their plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode on collated batches with at
least 256 node slots, so the kernel path, not its static fallback, is what
is compared. The CUDA kernels themselves are compared with the plain
versions on the card by ``tests/test_torch_kernels_gpu.py``.

Tolerances: fp32 sums are taken in another order on the two sides (the JAX
kernel adds one-hot matmul partials block by block, the port adds edge by
edge), so fp32 compares at rtol 1e-5 / atol 1e-5; bf16 outputs are fp32 sums
rounded once to bf16, where one rounding step of a differently ordered sum
is 2^-8 relative, so bf16 compares at rtol 1e-2 / atol 1e-2. Only real rows
are compared: the JAX kernel may leave the reserved dummy row N-1 different
(``hydragnn_tpu/ops/fused_scatter.py:229-237``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch thread)
from conftest import random_molecule_samples
from hydragnn_tpu.graphs.batching import collate, compute_pad_spec
from hydragnn_tpu.ops.fused_scatter import (
    fused_gather_scatter,
    fused_segment_sum,
    reference_gather_scatter,
)
from hydragnn_tpu_torch.ops import fused_scatter as fs

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=1e-2, atol=1e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def batch():
    """A collated QM9-sized batch: 16 molecules in 472 node slots, receivers
    sorted, pad edges wired to node N-1 with mask 0."""
    samples = random_molecule_samples(16, seed=3)
    b = collate(samples, compute_pad_spec(samples, 16))
    assert b.x.shape[0] >= 256 and b.meta.gs_fits
    return b


def _as_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _jax_np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _edges(batch, layout: str, rng):
    s, r, m = batch.senders, batch.receivers, batch.edge_mask
    if layout == "unsorted":
        p = rng.permutation(s.shape[0])
        s, r, m = s[p], r[p], m[p]
    elif layout == "empty_rows":
        keep = r % 3 != 0  # every third node receives nothing
        s, r, m = s[keep], r[keep], m[keep]
    return s, r, m


def _weight(kind, mask, c, rng):
    if kind == "none":
        return None
    if kind == "mask":
        return mask.astype(np.float32)
    return (rng.uniform(0.5, 2.0, size=(mask.shape[0], c)) * mask[:, None]).astype(np.float32)


CASES = [
    # (dtype, channels, weight kind, edge layout)
    ("float32", 64, "mask", "sorted"),
    ("float32", 64, "channel", "sorted"),
    ("float32", 64, "none", "sorted"),
    ("float32", 1, "mask", "sorted"),
    ("bfloat16", 1, "mask", "sorted"),
    ("bfloat16", 64, "mask", "sorted"),
    ("bfloat16", 64, "channel", "sorted"),
    ("float32", 64, "mask", "unsorted"),
    ("float32", 64, "mask", "empty_rows"),
    ("bfloat16", 64, "mask", "empty_rows"),
]


@pytest.mark.parametrize("dtype,c,wkind,layout", CASES)
def test_gather_scatter_sum_matches_jax(batch, dtype, c, wkind, layout):
    rng = np.random.default_rng(CASES.index((dtype, c, wkind, layout)))
    n = batch.x.shape[0]
    s, r, m = _edges(batch, layout, rng)
    h32 = rng.normal(size=(n, c)).astype(np.float32)
    w = _weight(wkind, m, c, rng)

    h_j = jnp.asarray(h32, JNP[dtype])
    w_j = None if w is None else jnp.asarray(w, JNP[dtype])
    kernel = fused_gather_scatter(h_j, jnp.asarray(s), jnp.asarray(r), n, w_j,
                                  interpret=True)
    ref = reference_gather_scatter(h_j, jnp.asarray(s), jnp.asarray(r), n, w_j)

    h_t = torch.from_numpy(h32).to(TORCH[dtype])
    w_t = None if w is None else torch.from_numpy(w).to(TORCH[dtype])
    before = dict(fs.LAUNCHES)
    got = fs.gather_scatter_sum(h_t, torch.from_numpy(s), torch.from_numpy(r), n, weight=w_t)
    assert fs.LAUNCHES == before, "the CPU route must not count kernel launches"
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == (n, c)

    real = slice(0, n - 1)
    np.testing.assert_allclose(_as_np(got)[real], _jax_np(kernel)[real], **TOL[dtype])
    np.testing.assert_allclose(_as_np(got)[real], _jax_np(ref.astype(JNP[dtype]))[real],
                               **TOL[dtype])
    if layout == "empty_rows":
        assert not _as_np(got)[0 : n - 1 : 3].any(), "a row without edges must be 0"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ids_kind", ["edges_to_nodes", "nodes_to_graphs", "unsorted"])
def test_segment_sum_matches_jax(batch, dtype, ids_kind):
    rng = np.random.default_rng(7)
    n, g = batch.x.shape[0], batch.graph_mask.shape[0]
    if ids_kind == "edges_to_nodes":  # N >= 128 segments: the Pallas kernel path
        ids, rows, segs = batch.receivers, batch.receivers.shape[0], n
    elif ids_kind == "nodes_to_graphs":  # the pooling call
        ids, rows, segs = batch.batch, n, g
    else:
        ids = batch.receivers[rng.permutation(batch.receivers.shape[0])]
        rows, segs = ids.shape[0], n
    data32 = rng.normal(size=(rows, 64)).astype(np.float32)

    data_j = jnp.asarray(data32, JNP[dtype])
    want = fused_segment_sum(data_j, jnp.asarray(ids), segs)
    if ids_kind == "nodes_to_graphs":
        # 17 segments are below the Pallas kernel's 128-row window, so the
        # JAX package takes its XLA route, which sums bf16 data in bf16;
        # the port sums in fp32 as the Pallas kernel does
        want = jax.ops.segment_sum(data_j.astype(jnp.float32), jnp.asarray(ids),
                                   num_segments=segs).astype(JNP[dtype])
    got = fs.fused_segment_sum(torch.from_numpy(data32).to(TORCH[dtype]),
                               torch.from_numpy(ids), segs)
    assert got.dtype == TORCH[dtype]
    np.testing.assert_allclose(_as_np(got)[: segs - 1], _jax_np(want)[: segs - 1],
                               **TOL[dtype])


def test_plain_versions_accumulate_in_fp32():
    """bf16 inputs are summed in fp32 and rounded once: 512 ones sum to 512,
    where a bf16 running sum would stall at 256 (256 + 1 rounds to 256)."""
    h = torch.ones((1, 1), dtype=torch.bfloat16)
    s = torch.zeros(512, dtype=torch.int32)
    r = torch.zeros(512, dtype=torch.int32)
    out = fs.plain_gather_scatter_sum(h, s, r, 1)
    assert out.dtype == torch.bfloat16 and float(out) == 512.0
    seg = fs.plain_segment_sum(h.expand(512, 1).contiguous(), r, 1)
    assert float(seg) == 512.0


def test_plain_versions_sum_fp64_input_in_fp64():
    """fp64 input is summed in fp64, so an fp64 step is a reference for the
    fp32 one: 1 + 2^-30 survives, which an fp32 sum rounds to 1."""
    h = torch.tensor([[1.0], [2.0 ** -30]], dtype=torch.float64)
    s = torch.tensor([0, 1], dtype=torch.int32)
    r = torch.zeros(2, dtype=torch.int32)
    out = fs.plain_gather_scatter_sum(h, s, r, 1)
    assert out.dtype == torch.float64 and float(out) == 1.0 + 2.0 ** -30
    assert float(fs.plain_segment_sum(h, r, 1)) == 1.0 + 2.0 ** -30
    assert fs.accumulate_dtype(torch.bfloat16) == torch.float32


@pytest.mark.parametrize("op", ["gather_scatter_sum", "gather_rows"])
def test_backward_passes_gradcheck_in_fp64(op):
    """The autograd Functions' backwards (B1's transposed launch and the
    weight's gradient; B2 summing a gather's gradient) against finite
    differences, in fp64, on ids with repeats and an empty row."""
    gen = torch.Generator().manual_seed(11)
    s = torch.tensor([0, 1, 1, 3, 4, 4, 4, 0], dtype=torch.int32)
    r = torch.tensor([1, 0, 3, 3, 0, 1, 3, 4], dtype=torch.int32)  # row 2 empty
    if op == "gather_scatter_sum":
        h = torch.randn(5, 3, generator=gen, dtype=torch.float64, requires_grad=True)
        w = torch.rand(8, generator=gen, dtype=torch.float64, requires_grad=True)
        assert torch.autograd.gradcheck(lambda h, w: fs.gather_scatter_sum(h, s, r, 5, weight=w),
                                        (h, w))
    else:
        x = torch.randn(5, 2, 3, generator=gen, dtype=torch.float64, requires_grad=True)
        assert torch.autograd.gradcheck(lambda x: fs.gather_rows(x, r), (x,))


@pytest.mark.parametrize("is_sorted", [True, False, None])
def test_segment_index_is_the_csr_the_kernels_read(batch, is_sorted):
    """``ptr``/``perm`` describe exactly the rows of each segment, in edge
    order: reducing through them row by row equals the plain version."""
    rng = np.random.default_rng(11)
    n = batch.x.shape[0]
    ids = batch.receivers if is_sorted else batch.receivers[rng.permutation(
        batch.receivers.shape[0])]
    ids_t = torch.from_numpy(ids)
    idx = fs.segment_index(ids_t, n, is_sorted=is_sorted)
    assert idx.ptr.dtype == torch.int32 and idx.ptr.shape == (n + 1,)
    assert int(idx.ptr[0]) == 0 and int(idx.ptr[-1]) == ids.shape[0]
    if is_sorted:
        assert idx.perm is None
    else:
        assert idx.perm.dtype == torch.int32
        np.testing.assert_array_equal(idx.perm.numpy(),
                                      np.argsort(ids, kind="stable"))
    lens = np.diff(idx.ptr.numpy())
    pieces = np.maximum(1, -(-lens // fs.PIECE_EDGES))
    np.testing.assert_array_equal(np.diff(idx.piece_ptr.numpy()), pieces)
    assert int(idx.piece_ptr[0]) == 0 and pieces.sum() <= idx.max_pieces
    assert pieces.max() > 1, "the dummy row's pad edges span several pieces"
    order = np.arange(ids.shape[0]) if idx.perm is None else idx.perm.numpy()
    data = rng.normal(size=(ids.shape[0], 8))  # float64: the sums compare exactly
    ptr = idx.ptr.numpy()
    csr = np.stack([data[order[ptr[k]:ptr[k + 1]]].sum(axis=0) for k in range(n)])
    want = np.zeros((n, 8))
    np.add.at(want, ids, data)
    np.testing.assert_allclose(csr, want, rtol=1e-12, atol=1e-12)
    for k in range(n):
        assert (ids[order[ptr[k]:ptr[k + 1]]] == k).all()


def test_wrappers_route_by_device_only():
    h = torch.ones(4, 2)
    s = torch.tensor([0, 1, 2], dtype=torch.int32)
    r = torch.tensor([1, 1, 3], dtype=torch.int32)
    out = fs.gather_scatter_sum(h, s, r, 4)
    np.testing.assert_array_equal(out.numpy(), [[0, 0], [2, 2], [0, 0], [1, 1]])
    with pytest.raises(ValueError, match="no route"):
        fs.gather_scatter_sum(h.to("meta"), s, r, 4)
    with pytest.raises(ValueError, match="no route"):
        fs.fused_segment_sum(h.to("meta"), s, 4)


def test_segment_ops_and_pooling_match_jax(batch):
    """``graphs.segment``: sum/mean/max/min pooling and counts against the
    JAX package's (XLA) versions on the batch's graph ids."""
    from hydragnn_tpu.graphs import segment as jseg
    from hydragnn_tpu_torch.graphs import segment as tseg

    rng = np.random.default_rng(5)
    n, g = batch.x.shape[0], batch.graph_mask.shape[0]
    x = (rng.normal(size=(n, 16)) * batch.node_mask[:, None]).astype(np.float32)
    for kind in ("add", "sum", "mean", "max", "min"):
        want = jseg.global_pool(kind, jnp.asarray(x), jnp.asarray(batch.batch), g)
        got = tseg.global_pool(kind, torch.from_numpy(x), torch.from_numpy(batch.batch), g)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6,
                                   err_msg=kind)
    np.testing.assert_array_equal(
        tseg.segment_count(torch.from_numpy(batch.batch), g).numpy(),
        np.asarray(jseg.segment_count(jnp.asarray(batch.batch), g)))
    with pytest.raises(ValueError, match="Unknown pooling"):
        tseg.global_pool("median", torch.from_numpy(x), torch.from_numpy(batch.batch), g)


@pytest.mark.parametrize("kind", ["max", "min"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_segment_extremes_of_non_finite_data_match_jax(batch, kind, dtype):
    """``segment_max``/``segment_min`` and their pooling where graphs hold
    +inf, -inf and NaN, and where graphs are empty: the JAX package zeroes
    every float output that is not finite and every int output equal to the
    reduction's identity (``hydragnn_tpu/graphs/segment.py::_zero_empty``)."""
    from hydragnn_tpu.graphs import segment as jseg
    from hydragnn_tpu_torch.graphs import segment as tseg

    rng = np.random.default_rng(17)
    n, g = batch.x.shape[0], batch.graph_mask.shape[0]
    ids = np.array(batch.batch)
    ids[ids == 3] = 4  # graph 3 becomes empty, beside the dummy graph's pads
    if dtype == "float32":
        x = rng.normal(size=(n, 6)).astype(np.float32)
        first = [int(np.flatnonzero(ids == k)[0]) for k in (0, 1, 2, 5)]
        x[first[0], 0] = np.inf  # a max of +inf, a min that stays finite
        x[first[1], 1] = -np.inf  # a min of -inf
        x[first[2], 2] = np.nan  # a NaN in a real graph
        x[first[3], :] = np.inf  # a whole row of +inf
    else:
        info = np.iinfo(np.int32)
        x = rng.integers(-50, 50, size=(n, 6)).astype(np.int32)
        x[int(np.flatnonzero(ids == 0)[0]), 0] = info.min  # the max's identity as data
        x[int(np.flatnonzero(ids == 1)[0]), 1] = info.max  # the min's identity as data
    jfn = getattr(jseg, f"segment_{kind}")
    tfn = getattr(tseg, f"segment_{kind}")
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(ids), g))
    got = tfn(torch.from_numpy(x), torch.from_numpy(ids), g).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got.astype(np.float64)).all()
    assert (got[3] == 0).all(), "an empty graph pools to 0"
    pooled = tseg.global_pool(kind, torch.from_numpy(x), torch.from_numpy(ids), g).numpy()
    np.testing.assert_array_equal(
        pooled, np.asarray(jseg.global_pool(kind, jnp.asarray(x), jnp.asarray(ids), g)))


@pytest.mark.parametrize("field", ["receivers", "senders", "batch", "loop_receivers",
                                   "loop_receivers shuffled"])
def test_piece_row_table_matches_numpy_on_collated_batches(batch, field):
    """The CSR kernels' host-built lookup (the segment sum's and the segment
    softmax's): ``piece_row[p]`` is the row of piece ``p`` for every piece,
    and ``num_segments`` for the spare ids up to ``max_pieces``; the tickets
    start at 0, one per row. Built from the port's own collated batch
    (``GraphBatch.csr``, as the models call it), and from GAT's extended
    receivers in a shuffled order (``segment_index``)."""
    from hydragnn_tpu_torch.graphs.batching import collate as tcollate
    from hydragnn_tpu_torch.graphs.graph import GraphSample

    rng = np.random.default_rng(23)
    samples = []
    for k in range(12):
        na = int(rng.integers(9, 30)) if k else 70  # one graph of 70 atoms: pooled in 3 pieces
        ne = int(rng.integers(0, 3 * na))
        samples.append(GraphSample(x=rng.normal(size=(na, 1)), pos=rng.normal(size=(na, 3)),
                                   senders=rng.integers(0, na, ne),
                                   receivers=np.sort(rng.integers(0, na, ne))))
    from hydragnn_tpu_torch.graphs.batching import compute_pad_spec as tpad

    b = tcollate(samples, tpad(samples, 12))
    if field.startswith("loop_receivers"):
        ids = b.self_loop_edges()[1].numpy()
    else:
        ids = getattr(b, field).numpy()
    if field.endswith("shuffled"):
        ids = ids[rng.permutation(ids.shape[0])]
        idx = fs.segment_index(torch.from_numpy(ids), b.num_nodes)
    else:
        idx = b.csr(field)
    rows = b.num_graphs if field == "batch" else b.num_nodes
    pieces = np.maximum(1, -(-np.bincount(ids, minlength=rows) // fs.PIECE_EDGES))
    want = np.full(idx.max_pieces, rows)
    want[: pieces.sum()] = np.repeat(np.arange(rows), pieces)
    assert idx.piece_row.dtype == torch.int32
    np.testing.assert_array_equal(idx.piece_row.numpy(), want)
    assert idx.tickets.dtype == torch.int32 and idx.tickets.shape == (rows,)
    assert not idx.tickets.any()
    assert pieces.max() > 1, "some row spans several pieces"


def test_piece_row_table_edge_cases():
    """No ids (every row one empty piece), trailing empty rows, and a single
    row of exactly 32 and of 33 ids."""
    for ids, rows, want in (([], 3, [0, 1, 2]),
                            ([0, 0, 1], 4, [0, 1, 2, 3, 4]),
                            ([0] * 32, 1, [0, 1]),
                            ([0] * 33, 1, [0, 0, 1])):
        idx = fs.segment_index(torch.tensor(ids, dtype=torch.int32), rows)
        np.testing.assert_array_equal(idx.piece_row.numpy(), want)
        assert idx.tickets.shape == (rows,) and not idx.tickets.any()
