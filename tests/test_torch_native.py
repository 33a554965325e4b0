"""The port's native host helpers (``hydragnn_tpu_torch/native``) on the CPU:
``radius_graph`` on 1,000 atoms, open and periodic, through the native
cell list, gives the JAX package's edges in the JAX package's order; the
native pairs are the numpy cell list's as sets; the native route refuses
point sets that are not [n, 3]; the build names its library by the
source's hash, survives concurrent builders and raises when ``g++`` fails
(no fallback).
"""

import threading

import numpy as np
import pytest

from hydragnn_tpu.graphs.radius import radius_graph as jax_radius_graph
from hydragnn_tpu_torch import native
from hydragnn_tpu_torch.graphs import radius
from hydragnn_tpu_torch.graphs.radius import radius_graph


def _atoms(n=1000, box=20.0, seed=0):
    return np.random.default_rng(seed).uniform(0.0, box, size=(n, 3))


@pytest.mark.parametrize("periodic,max_neighbours", [(False, None), (False, 12),
                                                     (True, None), (True, 12)])
def test_radius_graph_on_1000_atoms_equals_jax_in_order(periodic, max_neighbours):
    pos = _atoms()
    kw = dict(cell=np.diag([20.0, 20.0, 21.0]), pbc=np.array([True, True, periodic]))
    if not periodic:
        kw = {}
    n_pairs = pos.shape[0] * pos.shape[0] * (27 if periodic else 1)
    assert n_pairs > radius._BRUTE_FORCE_LIMIT ** 2  # the native route runs
    got = radius_graph(pos, 3.0, max_neighbours=max_neighbours, **kw)
    want = jax_radius_graph(pos, 3.0, max_neighbours=max_neighbours, **kw)
    for a, b, name in zip(got, want, ("senders", "receivers", "shifts")):
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got[0].size > 5000


def test_native_pairs_are_the_numpy_cell_lists_as_sets():
    pos = _atoms(seed=1)
    images = np.concatenate([pos, pos + np.array([20.0, 0.0, 0.0])])
    for query, points in ((pos, pos), (pos, images)):
        q, p = native.pairs_within_native(query, points, 2.5)
        q2, p2 = radius._pairs_within_numpy(query, points, 2.5)
        assert set(zip(q.tolist(), p.tolist())) == set(zip(q2.tolist(), p2.tolist()))
        assert len(q) == len(q2) and np.all(np.diff(q) >= 0)  # ascending queries
    # a pair buffer too small for the first pass is regrown, same pairs
    dense = np.random.default_rng(2).uniform(0.0, 2.0, size=(300, 3))
    q, p = native.pairs_within_native(dense, dense, 3.5)
    assert len(q) == 300 * 300


@pytest.mark.parametrize("query_shape,points_shape", [((5, 2), (5, 3)), ((5, 3), (5, 4)),
                                                     ((15,), (5, 3))])
def test_native_pairs_refuse_point_sets_that_are_not_n_by_3(query_shape, points_shape):
    with pytest.raises(ValueError, match=r"\[n, 3\] point sets"):
        native.pairs_within_native(np.zeros(query_shape), np.zeros(points_shape), 1.0)


def test_build_is_named_by_hash_and_survives_concurrent_builders(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    target = native.library_path("radius_graph.cpp")
    assert target.parent == tmp_path and target.name.startswith("libradius_graph-")
    errors = []

    def build():
        try:
            assert native.build("radius_graph.cpp") == target
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors and target.exists()
    assert [p.name for p in tmp_path.iterdir()] == [target.name]  # no temporary left


def test_a_failed_build_raises(tmp_path, monkeypatch):
    import subprocess

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)

    def broken(cmd, **kw):
        return subprocess.CompletedProcess(cmd, 1, "", "error: no compiler")

    monkeypatch.setattr(native.subprocess, "run", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build("radius_graph.cpp")

    def missing(cmd, **kw):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native.subprocess, "run", missing)
    with pytest.raises(RuntimeError, match="building radius_graph.cpp failed"):
        native.build("radius_graph.cpp")
    assert list(tmp_path.iterdir()) == []
