"""The port's edge-sharded route for SchNet and EGNN (each with its
coordinate updates on: the gate MLP on edges, the sender-side mean of
every rank's edges) and PAINN (vector messages summed by sender, flattened
as ``[E, 3 F]``, then summed over the ranks) on two ``gloo`` ranks, against
the JAX package's edge-sharded steps on a 2-device mesh and the port's
one-device steps (``torch_edge_sharded_util.py``: hidden 8, 2 conv
layers, four 400-atom graphs; outputs, eval metrics, one SGD step at lr
0.1, every gradient, the parameters of the filter and gate networks that
act on edge rows among them; the ranks' parameters bit-equal after the
step).

Tolerance: rtol 1e-5 / atol 1e-6, as ``test_torch_large_graph.py``.
"""

import pytest

import torch_edge_sharded_util as esu
from torch_parallel_pool import WorkerPool


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = WorkerPool(tmp_path_factory.mktemp("edge_geometric"))
    yield p
    p.close()


@pytest.mark.parametrize("stack", ["SchNet", "EGNN", "PAINN"])
def test_geometric_stack_edge_sharded_matches_jax_and_one_device(pool, stack):
    esu.check_stack(pool, stack)
