"""The port's neighbour builds for MD (``hydragnn_tpu_torch.md``) against
the JAX package's, on the same float32 positions made with numpy.

* the cell list's plain route (the CPU route of kernel B5) against JAX
  ``binned_radius_graph(fused=False)``, the XLA build: the arrays identical
  (the port emits the XLA build's edge order), shifts within 1e-6 (both
  compute them by the same three-term products; they agree bit for bit
  here);
* against the Pallas kernel in interpret mode, which emits the same edges
  cell-major: edge sets equal, shifts within 1e-5 (the kernel's
  ``HIGHEST``-precision dots round in another order);
* the overflow poison, ``plan_cell_grid``, and the dense build
  ``dynamic_radius_graph`` (arrays identical, the pad-slot convention, the
  int32 guards).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch thread)
from hydragnn_tpu import md as jmd
from hydragnn_tpu.ops.fused_cell_list import fused_binned_radius_graph
from hydragnn_tpu_torch import md
from hydragnn_tpu_torch.ops import fused_scatter as fs

PBC = {"periodic": (True, True, True), "slab": (True, True, False),
       "wire": (True, False, False), "open": (False, False, False)}


def _stage(n=400, box=12.0, seed=1):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, box, size=(n, 3)).astype(np.float32)
    return pos, np.eye(3, dtype=np.float32) * box


def _jax_binned(pos, cutoff, max_edges, cell, pbc, grid, cap, pad_id=0):
    out = jmd.binned_radius_graph(jnp.asarray(pos), cutoff, max_edges, jnp.asarray(cell),
                                  jnp.asarray(np.asarray(pbc)), grid, cap, pad_id=pad_id,
                                  fused=False)
    return [np.asarray(a) for a in out]


def _port_binned(pos, cutoff, max_edges, cell, pbc, grid, cap, pad_id=0):
    out = md.binned_radius_graph(torch.from_numpy(pos), cutoff, max_edges, cell,
                                 np.asarray(pbc), grid, cap, pad_id=pad_id)
    return [a.numpy() for a in out]


def _assert_same_arrays(got, want, shift_tol=1e-6):
    s, r, sh, m, ne = got
    ws, wr, wsh, wm, wne = want
    assert int(ne) == int(wne)
    np.testing.assert_array_equal(s, ws)
    np.testing.assert_array_equal(r, wr)
    np.testing.assert_array_equal(m, wm)
    np.testing.assert_allclose(sh, wsh, rtol=0, atol=shift_tol)
    assert s.dtype == r.dtype == np.int32 and sh.dtype == m.dtype == np.float32


@pytest.mark.parametrize("kind", sorted(PBC))
def test_cell_list_plain_route_equals_xla_build(kind):
    pos, cell = _stage()
    pbc = PBC[kind]
    grid, cap = md.plan_cell_grid(cell, 2.5, pos.shape[0], pbc=np.asarray(pbc))
    want = _jax_binned(pos, 2.5, 16384, cell, pbc, grid, cap, pad_id=399)
    before = dict(fs.LAUNCHES)
    got = _port_binned(pos, 2.5, 16384, cell, pbc, grid, cap, pad_id=399)
    assert fs.LAUNCHES == before, "the CPU route must not count kernel launches"
    _assert_same_arrays(got, want)
    k = int(got[4])
    assert k > 1000
    # the XLA build's order: senders non-decreasing, pads at pad_id after them
    assert np.all(np.diff(got[0][:k]) >= 0) and np.all(got[0][k:] == 399)


def test_cell_list_truncation_keeps_the_xla_prefix():
    pos, cell = _stage()
    grid, cap = md.plan_cell_grid(cell, 2.5, pos.shape[0])
    want = _jax_binned(pos, 2.5, 1000, cell, PBC["periodic"], grid, cap)
    got = _port_binned(pos, 2.5, 1000, cell, PBC["periodic"], grid, cap)
    _assert_same_arrays(got, want)
    assert int(got[4]) > 1000 and got[3].sum() == 1000


def test_cell_list_edge_set_equals_pallas_kernel():
    """The Pallas kernel in interpret mode (as ``tests/test_fused_cell_list.py``
    runs it) emits the same edges cell-major."""
    pos, cell = _stage(n=420)
    pbc = np.ones(3, bool)
    grid, cap = md.plan_cell_grid(cell, 2.5, pos.shape[0])
    fus = fused_binned_radius_graph(jnp.asarray(pos), 2.5, 16384, jnp.asarray(cell),
                                    jnp.asarray(pbc), grid, cap, interpret=True)
    fs_, fr, fsh, fm, fne = [np.asarray(a) for a in fus]
    s, r, sh, m, ne = _port_binned(pos, 2.5, 16384, cell, pbc, grid, cap)
    assert int(ne) == int(fne)
    k = int(ne)
    got = {(a, b): sh[i] for i, (a, b) in enumerate(zip(s[:k].tolist(), r[:k].tolist()))}
    want = {(a, b): fsh[i] for i, (a, b) in enumerate(zip(fs_[:k].tolist(), fr[:k].tolist()))}
    assert set(got) == set(want) and len(got) == k
    for pair, shift in want.items():
        np.testing.assert_allclose(got[pair], shift, rtol=0, atol=1e-5)


def test_cell_list_overflow_poisons_n_edges():
    """A cell past ``capacity`` trips the caller's ``n_edges <= max_edges``
    check with the XLA build's value, ``max_edges + max_occupancy``."""
    pos, cell = _stage()
    grid, _ = md.plan_cell_grid(cell, 2.5, pos.shape[0])
    want = _jax_binned(pos, 2.5, 16384, cell, PBC["periodic"], grid, 3)
    got = _port_binned(pos, 2.5, 16384, cell, PBC["periodic"], grid, 3)
    assert int(got[4]) == int(want[4]) > 16384


@pytest.mark.parametrize("cell,cutoff,n,pbc", [
    (np.eye(3) * 12.0, 2.5, 420, None),
    (np.eye(3) * 38.0, 5.0, 1000, None),
    (np.eye(3) * 30.8, 3.0, 8000, None),
    (np.diag([12.0, 12.0, 4.0]), 2.5, 300, (True, True, False)),
    (np.diag([12.0, 12.0, 4.0]), 2.5, 300, None),  # periodic axis under 3 cells
    (np.array([[10.0, 0, 0], [3.0, 9.0, 0], [1.0, 2.0, 11.0]]), 2.0, 500, None),
    (np.zeros((3, 3)), 2.0, 10, None),
])
def test_plan_cell_grid_matches_jax(cell, cutoff, n, pbc):
    for factor in (2.5, 1.05):
        assert md.plan_cell_grid(cell, cutoff, n, capacity_factor=factor, pbc=pbc) == \
            jmd.plan_cell_grid(cell, cutoff, n, capacity_factor=factor, pbc=pbc)


@pytest.mark.parametrize("kind", ["periodic", "slab", "cell_without_pbc", "open"])
def test_dynamic_radius_graph_equals_jax(kind):
    pos, cell = _stage(n=150, box=8.0, seed=2)
    pbc = {"periodic": PBC["periodic"], "slab": PBC["slab"]}.get(kind)
    c = None if kind == "open" else cell
    kw = dict(cell=c, pbc=None if pbc is None else np.asarray(pbc), pad_id=149)
    want = jmd.dynamic_radius_graph(jnp.asarray(pos), 2.0, 4096,
                                    cell=None if c is None else jnp.asarray(c),
                                    pbc=None if pbc is None else jnp.asarray(np.asarray(pbc)),
                                    pad_id=149)
    got = md.dynamic_radius_graph(torch.from_numpy(pos), 2.0, 4096, **kw)
    _assert_same_arrays([a.numpy() for a in got], [np.asarray(a) for a in want])


def test_dynamic_radius_graph_pad_slots_and_overflow():
    pos, cell = _stage(n=60, box=5.0, seed=3)
    s, r, sh, m, ne = md.dynamic_radius_graph(torch.from_numpy(pos), 2.0, 2048, pad_id=59)
    k = int(ne)
    assert 0 < k < 2048 and m[:k].eq(1).all() and m[k:].eq(0).all()
    assert s[k:].eq(59).all() and r[k:].eq(59).all() and sh[k:].eq(0).all()
    # an overflow keeps the nearest-by-index prefix and flags itself
    s2, r2, _, m2, ne2 = md.dynamic_radius_graph(torch.from_numpy(pos), 2.0, k // 2)
    assert int(ne2) == k and m2.eq(1).all()
    assert torch.equal(s2, s[: k // 2]) and torch.equal(r2, r[: k // 2])


def test_neighbour_builds_guard_int32_indices():
    with pytest.raises(ValueError, match="int32"):
        md.dynamic_radius_graph(torch.zeros(46341, 3), 1.0, 8)
    pos, cell = _stage(n=100)
    with pytest.raises(ValueError, match="int32"):
        md.binned_radius_graph(torch.from_numpy(pos), 2.5, 8, cell, np.ones(3, bool),
                               (4, 4, 4), 800_000)
