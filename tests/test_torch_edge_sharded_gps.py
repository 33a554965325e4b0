"""GPS multihead attention around GIN and around GAT on the port's
edge-sharded route: the attention, the norms and the MLP are node-level
and replicated on every rank; the local conv's edge features (the embedded
relative encodings, whose ``rel_pos_emb`` acts on edge rows) and, for GAT,
its self loops' mean edge feature, are every rank's. On two ``gloo`` ranks
against the JAX package's edge-sharded steps on a 2-device mesh and the
port's one-device steps (``torch_edge_sharded_util.py``: hidden 8, 2 conv
layers, four 400-atom graphs with Laplacian encodings; outputs, eval
metrics, one SGD step at lr 0.1, every gradient; the ranks' parameters
bit-equal after the step).

Tolerance: rtol 1e-5 / atol 1e-6, as ``test_torch_large_graph.py`` (its
GPS ``ring`` case keeps atol 1e-5 for the ring's online softmax; the
multihead softmax normalises once, as on one device).
"""

import pytest

import torch_edge_sharded_util as esu
from torch_parallel_pool import WorkerPool


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = WorkerPool(tmp_path_factory.mktemp("edge_gps"))
    yield p
    p.close()


@pytest.mark.parametrize("stack", ["GIN", "GAT"])
def test_gps_multihead_edge_sharded_matches_jax_and_one_device(pool, stack):
    esu.check_stack(pool, stack, gps="multihead")
