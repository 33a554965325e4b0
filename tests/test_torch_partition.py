"""The port's spatial partition (``hydragnn_tpu_torch/graphs/partition.py``)
and halo plans (``parallel/halo.py::partition_graph_batch``) against the
JAX package's: exactly equal, array for array and dtype for dtype (both are
host-side numpy, so no tolerance applies)."""

import numpy as np
import pytest

from hydragnn_tpu.graphs import partition as jpart
from hydragnn_tpu.parallel import halo as jhalo
from hydragnn_tpu_torch.graphs import partition as part
from hydragnn_tpu_torch.graphs.graph import FIELDS
from hydragnn_tpu_torch.parallel import halo
from test_halo import build


def _equal(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: {a.dtype} != {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=what)


def _positions(n=500, seed=0, box=12.0):
    return np.random.default_rng(seed).uniform(0, box, size=(n, 3))


@pytest.mark.parametrize("n_parts", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("cutoff", [None, 2.5], ids=["auto_grid", "cell_list_grid"])
def test_partition_nodes_equals_jax(n_parts, cutoff):
    pos = _positions()
    got = part.partition_nodes(pos, n_parts, cutoff=cutoff)
    want = jpart.partition_nodes(pos, n_parts, cutoff=cutoff)
    for f in ("order", "owner", "start", "cid"):
        _equal(getattr(got, f), getattr(want, f), f)
    assert got.grid == want.grid and got.n_parts == want.n_parts == n_parts
    for p in range(n_parts):
        _equal(got.part(p), want.part(p), f"part {p}")


def test_periodic_cells_morton_codes_and_boundaries_equal_jax():
    rng = np.random.default_rng(1)
    cell = np.diag([10.0, 11.0, 12.0]) + 0.3 * np.triu(rng.normal(size=(3, 3)), 1)
    pos = rng.uniform(-2, 13, size=(300, 3))  # outside the box too: wrapped
    for pbc in (None, [True, False, True]):
        got = part.cell_assignment(pos, (4, 5, 6), cell, pbc=pbc)
        want = jpart.cell_assignment(pos, (4, 5, 6), cell, pbc=pbc)
        _equal(got[0], want[0], "idx3")
        _equal(got[1], want[1], "cid")
        _equal(part.morton_codes(got[0]), jpart.morton_codes(want[0]), "morton")
        g = part.partition_nodes(pos, 4, cell=cell, pbc=pbc, cutoff=2.5)
        w = jpart.partition_nodes(pos, 4, cell=cell, pbc=pbc, cutoff=2.5)
        _equal(g.order, w.order, "order")
        _equal(g.owner, w.owner, "owner")
    _equal(part.bounding_cell(pos), jpart.bounding_cell(pos), "bounding cell")
    senders = rng.integers(0, 300, 2000)
    receivers = rng.integers(0, 300, 2000)
    owner = jpart.partition_nodes(pos, 4).owner
    got = part.boundary_sets(senders, receivers, owner, 4)
    want = jpart.boundary_sets(senders, receivers, owner, 4)
    assert sorted(got) == sorted(want)
    for k in want:
        _equal(got[k], want[k], f"boundary {k}")
    for bad in (-1, 1 << 21):
        with pytest.raises(ValueError, match="morton_codes"):
            part.morton_codes(np.array([[0, 0, bad]]))
    with pytest.raises(ValueError, match="at least one node"):
        part.partition_nodes(pos[:3], 4)


@pytest.mark.parametrize("n_parts", [2, 4])
@pytest.mark.parametrize("node_head", [False, True], ids=["graph_head", "node_head"])
def test_halo_plans_equal_jax(n_parts, node_head):
    """Every local view's fields, the ring schedule, the global ids and the
    owned counts of the halo partition; the analytic byte counts."""
    _, batch, _ = build(n=300, node_head=node_head)
    cfg = halo.HaloConfig(slot_multiple=4, node_multiple=8, edge_multiple=64)
    jcfg = jhalo.HaloConfig(slot_multiple=4, node_multiple=8, edge_multiple=64)
    got = halo.partition_graph_batch({f: np.asarray(getattr(batch, f)) for f in FIELDS},
                                     n_parts, cfg=cfg, cutoff=2.5)
    want = jhalo.partition_graph_batch(batch, n_parts, cfg=jcfg, cutoff=2.5)
    for f in FIELDS:
        _equal(got.batch[f], getattr(want.batch, f), f)
    assert len(got.plan.send_idx) == len(want.plan.send_idx) == n_parts - 1
    for g, w in zip(got.plan.send_idx + got.plan.recv_slot,
                    want.plan.send_idx + want.plan.recv_slot):
        _equal(g, w, "plan")
    _equal(got.node_global, want.node_global, "node_global")
    _equal(got.n_owned, want.n_owned, "n_owned")
    assert halo.halo_boundary_bytes(got.plan, 64) == jhalo.halo_boundary_bytes(want.plan, 64)
    assert halo.replicated_allreduce_bytes(300, 64, n_parts) == \
        jhalo.replicated_allreduce_bytes(300, 64, n_parts)
    stacked = np.random.default_rng(0).normal(size=got.node_global.shape + (3,))
    _equal(halo.gather_node_predictions(stacked, got),
           jhalo.gather_node_predictions(stacked, want), "gathered")


def test_one_partition_is_the_whole_graph_in_morton_order():
    """The port's single-rank form (the JAX package needs two or more
    parts): every node owned, no halo, no exchange."""
    _, batch, _ = build(n=300)
    hb = halo.partition_graph_batch({f: np.asarray(getattr(batch, f)) for f in FIELDS}, 1,
                                    cutoff=2.5)
    assert hb.plan.send_idx == () and int(hb.n_owned[0]) == 300
    order = part.partition_nodes(np.asarray(batch.pos)[:300], 1, cutoff=2.5).order
    _equal(hb.node_global[0, :300], order.astype(np.int32), "owned ids")
    np.testing.assert_array_equal(hb.batch["x"][0, :300], np.asarray(batch.x)[order])
    assert hb.batch["edge_mask"][0].sum() == np.asarray(batch.edge_mask).sum()


def test_halo_config_and_support_match_jax(monkeypatch):
    assert halo.halo_config_defaults() == jhalo.halo_config_defaults()
    arch = {"halo": {"enabled": True, "slot_multiple": 16}}
    assert halo.halo_config(arch) == halo.HaloConfig(**vars(jhalo.halo_config(arch)))
    for bad in ({"partitions": -1}, {"edge_multiple": 0}, {"fallback": "maybe"}):
        with pytest.raises(ValueError):
            halo.halo_config({"halo": bad})
    monkeypatch.setenv("HYDRAGNN_HALO", "0")
    assert halo.halo_enabled(arch) is False is jhalo.halo_enabled(arch)
    monkeypatch.setenv("HYDRAGNN_HALO", "1")
    assert halo.halo_enabled({}) is True is jhalo.halo_enabled({})
    assert halo.HALO_SUPPORTED_CONVS == jhalo.HALO_SUPPORTED_CONVS
    from hydragnn_tpu.graphs.batching import collate, compute_pad_spec
    from test_halo import giant_sample

    two = [giant_sample(50, seed=s) for s in (1, 2)]
    pair = collate(two, compute_pad_spec(two, 2))
    with pytest.raises(ValueError, match="exactly 1 real graph"):
        halo.partition_graph_batch({f: np.asarray(getattr(pair, f)) for f in FIELDS}, 2)
