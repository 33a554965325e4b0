"""The port's ring attention (``hydragnn_tpu_torch/parallel/
ring_attention.py``) on two ``gloo`` ranks against the JAX package's ring
over a 2-device mesh, and against the port's own one-rank ring and the
exact flat attention: outputs and the gradients of ``sum(out * g)`` with
respect to the replicated queries, keys and values (the JAX side by
``jax.grad`` through its ``shard_map``; the port's by its second ring pass).

Tolerances: fp32 outputs and gradients rtol 1e-5 / atol 1e-6 (the online
softmax rescales each hop's partial sums; XLA and PyTorch round its
``exp``s and ``einsum``s apart); the one-rank ring against the flat
attention in fp64, to 1e-12. Pad rows (whose graph has no real key) are
compared only where the JAX ring defines them: 0.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.parallel import make_mesh
from hydragnn_tpu.parallel.ring_attention import ring_attention as jax_ring
from torch_parallel_pool import WorkerPool

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = WorkerPool(tmp_path_factory.mktemp("ring"))
    yield p
    p.close()


def _inputs(n=24, heads=2, dh=4, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    bid = np.repeat(np.arange(4), [7, 5, 8, 4]).astype(np.int32)  # graph 3: the pad graph
    mask = (bid < 3).astype(dtype)
    out = {k: rng.normal(size=(n, heads, dh)).astype(dtype) for k in ("q", "k", "v", "g")}
    return dict(out, bid=bid, mask=mask)


def _flat(q, k, v, bid, mask):
    logits = torch.einsum("nhd,mhd->hnm", q, k) / math.sqrt(q.shape[-1])
    valid = (bid[:, None] == bid[None, :]) & (mask[None, :] > 0)
    p = torch.softmax(torch.where(valid[None], logits, torch.full_like(logits, -1e9)), -1)
    return torch.einsum("hnm,mhd->nhd", p * valid.any(-1)[None, :, None], v)


def test_ring_over_two_ranks_matches_jax(pool):
    inp = _inputs()
    outs = pool.run("ring", inp)
    mesh = make_mesh(devices=jax.devices()[:2])
    args = [jnp.asarray(inp[k]) for k in ("q", "k", "v")]
    bid, mask, g = jnp.asarray(inp["bid"]), jnp.asarray(inp["mask"]), jnp.asarray(inp["g"])

    def f(q, k, v):
        return (jax_ring(q, k, v, bid, mask, mesh) * g).sum()

    want = np.asarray(jax_ring(*args, bid, mask, mesh))
    grads = [np.asarray(x) for x in jax.grad(f, argnums=(0, 1, 2))(*args)]
    for out in outs:
        np.testing.assert_allclose(out["out"], want, **TOL)
        for name, w in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(out[name], w, **TOL, err_msg=name)
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k])


def test_one_rank_ring_is_the_exact_attention():
    """No group: one block, the flat same-graph attention and its gradients
    (fp64)."""
    from hydragnn_tpu_torch.parallel.ring_attention import ring_attention

    inp = _inputs(dtype=np.float64)
    qkv = [torch.tensor(inp[k], requires_grad=True) for k in ("q", "k", "v")]
    bid, mask = torch.tensor(inp["bid"]), torch.tensor(inp["mask"])
    out = ring_attention(*qkv, bid, mask)
    (out * torch.tensor(inp["g"])).sum().backward()
    got = [t.grad.clone() for t in qkv]
    for t in qkv:
        t.grad = None
    ref = _flat(*qkv, bid, mask)
    (ref * torch.tensor(inp["g"])).sum().backward()
    torch.testing.assert_close(out, ref, rtol=1e-12, atol=1e-12)
    for a, t in zip(got, qkv):
        torch.testing.assert_close(a, t.grad, rtol=1e-12, atol=1e-12)
    assert (out.detach()[inp["bid"] == 3] == 0).all()


def test_a_node_count_the_ranks_do_not_divide_is_refused(monkeypatch):
    """As the JAX ring refuses it (a group of 2, pretended)."""
    import torch.distributed as dist

    from hydragnn_tpu_torch.parallel.ring_attention import ring_attention

    inp = _inputs()
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    with pytest.raises(ValueError, match="divisible"):
        ring_attention(*(torch.tensor(inp[k][:23]) for k in ("q", "k", "v")),
                       torch.tensor(inp["bid"][:23]), torch.tensor(inp["mask"][:23]))
