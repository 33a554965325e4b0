"""The geometric stacks (SchNet, EGNN, PAINN, PNAEq, MACE, DimeNet) on the
port's edge-sharded route in a process group of one rank: the one-device
step bit for bit (``test_torch_edge_sharded_world1.py`` says why and holds
the other stacks).
"""

import pytest

from test_torch_edge_sharded_world1 import check_one_rank
from torch_parallel_pool import WorkerPool


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = WorkerPool(tmp_path_factory.mktemp("edge_world1_geometric"), world=1)
    yield p
    p.close()


@pytest.mark.parametrize("stack", ["SchNet", "EGNN", "PAINN", "PNAEq", "MACE", "DimeNet"])
def test_geometric_edge_sharded_at_one_rank_is_the_one_device_step_bit_for_bit(pool, stack):
    check_one_rank(pool, stack)
