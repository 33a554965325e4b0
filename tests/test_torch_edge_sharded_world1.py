"""The port's edge-sharded route in a process group of one rank: every
collective is the identity on the values, the split softmax's combine of
one rank's statistics is ``M`` and ``S exp(0)``, and every edge-space
helper keeps the one-device call's order of operations, so each of the
thirteen stacks' outputs, gradients and parameters after one SGD step are
the one-device step's bit for bit (``chip_smoke.py`` holds GAT's so on the
card). Cases of ``torch_edge_sharded_util.py`` at half their atoms (hidden
8, 2 conv layers, four 200-atom graphs at the same density: bits need no
size), one ``gloo`` rank; the geometric stacks in
``test_torch_edge_sharded_world1_geometric.py``.
"""

import numpy as np
import pytest

import torch_edge_sharded_util as esu
from test_torch_large_graph import _port_single
from torch_parallel_pool import WorkerPool


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = WorkerPool(tmp_path_factory.mktemp("edge_world1"), world=1)
    yield p
    p.close()


@pytest.mark.parametrize("stack", ["GIN", "SAGE", "MFC", "GAT", "PNA", "PNAPlus", "CGCNN"])
def test_edge_sharded_at_one_rank_is_the_one_device_step_bit_for_bit(pool, stack):
    check_one_rank(pool, stack)


def check_one_rank(pool, stack: str) -> None:
    _, batch, aug, variables = esu.case(stack, n_atoms=200, box=9.5)
    (out,) = esu.run_ranks(pool, aug, variables, batch)
    sout, sev, sm, sgrads, sstate = _port_single(aug, variables, batch)
    for got, want in zip(out["outputs"], sout):
        np.testing.assert_array_equal(got, want)
    for k, v in sev.items():
        np.testing.assert_array_equal(out["eval"][k], v, err_msg=k)
    np.testing.assert_array_equal(out["step"]["loss"], sm["loss"])
    for name, v in sgrads.items():
        np.testing.assert_array_equal(out["grads"][name], v, err_msg=f"gradient {name}")
    for name, v in sstate.items():
        np.testing.assert_array_equal(out["state"][name], v, err_msg=name)
