"""The port's segment ops, edge attention and NK attention against the JAX package.

  * ``segment_max`` / ``segment_softmax`` match the JAX ops, masked lanes
    and empty segments included;
  * the plain ``edge_attention`` matches ``ea.edge_attention`` in fp32 to
    1e-5, single frame and packed, and in bf16 to rtol = atol = 0.02 (two
    bf16 roundings of values below 2 in size, and bf16 scatter-adds that
    the two packages take in another order);
  * on CPU tensors ``fused_edge_attention_nk`` (the plain version,
    ``edge_attention`` on the slot arrays) matches the Pallas kernel in
    interpret mode at rtol 0.03, atol 0.02, the JAX suite's
    kernel-vs-kernel bound (tests/test_fused_edge_attention_nk.py:96-99),
    and counts no launch; in fp32 it matches ``ea.edge_attention`` on the
    original edge list to 1e-5;
  * a receiver with no valid slot gets exact zeros.
The CUDA kernel itself is tested on a card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.ops import edge_attention as jea
from graph_physics_tpu.ops import segment as jseg
from graph_physics_tpu.ops.fused_edge_attention_nk import build_nk_tiling as j_build_nk
from graph_physics_tpu.ops.fused_edge_attention_nk import fused_edge_attention_nk as j_fused
from graph_physics_tpu_torch.ops import segment as tseg
from graph_physics_tpu_torch.ops import tiling as ttiling
from graph_physics_tpu_torch.ops.edge_attention import edge_attention
from graph_physics_tpu_torch.ops.fused_edge_attention_nk import (
    fused_edge_attention_nk,
    fused_edge_attention_nk_reference,
)
from tests.helpers import tiny_graph
from tests.test_torch_fused_gnblock_nk import _port_host_graph

B, HEADS, DH = 2, 4, 16
TOL = dict(rtol=1e-5, atol=1e-5)


def _segments(seed=0, e=300, n=40):
    """Values [E, B, H], segment ids with empty segments, a mask."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n - 5, e).astype(np.int32)  # the last 5 segments stay empty
    vals = rng.normal(size=(e, B, HEADS)).astype(np.float32) * 3.0
    mask = rng.random(e) > 0.3
    return vals, ids, mask, n


@pytest.mark.parametrize("masked", [False, True])
def test_segment_max_matches_jax(masked):
    vals, ids, mask, n = _segments()
    m = mask if masked else None
    want = np.asarray(jseg.segment_max(jnp.asarray(vals), jnp.asarray(ids), n,
                                       None if m is None else jnp.asarray(m)))
    got = tseg.segment_max(torch.as_tensor(vals), torch.as_tensor(ids), n,
                           None if m is None else torch.as_tensor(m)).numpy()
    assert np.isneginf(got[-5:]).all() and np.isneginf(want[-5:]).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_segment_softmax_matches_jax(masked):
    vals, ids, mask, n = _segments(seed=1)
    m = mask if masked else None
    want = np.asarray(jseg.segment_softmax(jnp.asarray(vals), jnp.asarray(ids), n,
                                           None if m is None else jnp.asarray(m)))
    got = tseg.segment_softmax(torch.as_tensor(vals), torch.as_tensor(ids), n,
                               None if m is None else torch.as_tensor(m)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if masked:
        assert not got[~mask].any()


def _edge_case(packed, seed=0):
    g = tiny_graph(nx=14, ny=10)
    rng = np.random.default_rng(seed)
    lead = (g.x.shape[0], B) if packed else (g.x.shape[0],)
    q, k, v = [(0.5 * rng.normal(size=lead + (HEADS, DH))).astype(np.float32)
               for _ in range(3)]
    return g, q, k, v


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edge_attention_matches_jax(packed, dtype):
    g, q, k, v = _edge_case(packed)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jea.edge_attention(*(jnp.asarray(a, jd) for a in (q, k, v)), jnp.asarray(g.senders),
                              jnp.asarray(g.receivers), jnp.asarray(g.edge_mask))
    got = edge_attention(*(torch.as_tensor(a).to(td) for a in (q, k, v)),
                         torch.as_tensor(g.senders), torch.as_tensor(g.receivers),
                         torch.as_tensor(g.edge_mask))
    assert got.dtype == td
    tol = TOL if dtype == "float32" else dict(rtol=0.02, atol=0.02)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_edge_attention_returns_weights_and_refuses_what_is_not_ported():
    g, q, k, v = _edge_case(packed=False)
    args = [torch.as_tensor(a) for a in (q, k, v, g.senders, g.receivers, g.edge_mask)]
    _, alpha = edge_attention(*args, return_weights=True)
    _, want = jea.edge_attention(*(jnp.asarray(a) for a in (q, k, v, g.senders, g.receivers,
                                                             g.edge_mask)), return_weights=True)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(want), **TOL)
    with pytest.raises(NotImplementedError, match="world"):  # as JAX refuses it
        edge_attention(*args, return_weights=True, wedge_senders=args[3],
                       wedge_receivers=args[4], wedge_mask=args[5])
    with pytest.raises(NotImplementedError, match="sequence"):
        edge_attention(*args, sp_axis_name="sp")
    _, qp, kp, vp = _edge_case(packed=True)
    with pytest.raises(NotImplementedError, match="packed"):
        edge_attention(*(torch.as_tensor(a) for a in (qp, kp, vp)), *args[3:],
                       return_weights=True)


def _nk_case(seed=0):
    """q, k, v [N, B, H, dh] on the 14x10 mesh's NK layout, both packages'
    tilings and the port's slot arrays."""
    g = tiny_graph(nx=14, ny=10)
    args = (np.asarray(g.senders), np.asarray(g.receivers), g.x.shape[0])
    jt = j_build_nk(*args, edge_mask=np.asarray(g.edge_mask), node_block=128)
    tt = ttiling.build_nk_tiling(*args, edge_mask=np.asarray(g.edge_mask))
    tg = ttiling.apply_to_graph_nk(_port_host_graph(g), tt)
    rng = np.random.default_rng(seed)
    q, k, v = [(0.5 * rng.normal(size=(tt.num_nodes, B, HEADS, DH))).astype(np.float32)
               for _ in range(3)]
    return g, jt, tt, tg, q, k, v


def _slots(tg):
    """The port graph's slot arrays: senders, receivers, edge_mask."""
    return tuple(torch.as_tensor(a) for a in (tg.senders, tg.receivers, tg.edge_mask))


def test_nk_wrapper_on_cpu_matches_pallas_interpret():
    g, jt, tt, tg, q, k, v = _nk_case(seed=2)
    want = j_fused(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jt, interpret=True)
    before = fused_edge_attention_nk.launches
    got = fused_edge_attention_nk(*(torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v)),
                                  *_slots(tg), tt)
    assert fused_edge_attention_nk.launches == before  # CPU tensors: plain version, no launch
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0.03, atol=0.02)


def test_nk_reference_fp32_matches_edge_attention():
    """The slot-table gather and the per-receiver softmax are the edge-list
    attention's: in fp32 they agree on every node."""
    g, jt, tt, tg, q, k, v = _nk_case(seed=3)
    n = g.x.shape[0]
    want = jea.edge_attention(*(jnp.asarray(a[:n]) for a in (q, k, v)),
                              jnp.asarray(g.senders), jnp.asarray(g.receivers),
                              jnp.asarray(g.edge_mask))
    got = fused_edge_attention_nk_reference(*(torch.as_tensor(a) for a in (q, k, v)),
                                            *_slots(tg), tt)
    np.testing.assert_allclose(got.numpy()[:n], np.asarray(want), **TOL)
    assert not got.numpy()[n:].any()  # padded nodes receive nothing


def test_nk_empty_receivers_give_exact_zeros():
    g, jt, tt, tg, q, k, v = _nk_case(seed=4)
    mask = np.asarray(tg.edge_mask).reshape(tt.num_groups, tt.k_slots, tt.node_block).copy()
    mask[:, :, :7] = False  # seven receivers per node block lose every slot
    mask = torch.as_tensor(mask.reshape(-1))
    got = fused_edge_attention_nk(*(torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v)),
                                  *_slots(tg)[:2], mask, tt)
    empty = got.view(tt.num_groups, tt.node_block, B, HEADS, DH)[:, :7]
    assert torch.equal(empty, torch.zeros_like(empty))
    want = edge_attention(*(torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v)),
                          torch.as_tensor(tg.senders), torch.as_tensor(tg.receivers), mask)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=0.03, atol=0.02)


def test_nk_wrapper_checks_inputs():
    g, jt, tt, tg, q, k, v = _nk_case()
    s, r, m = _slots(tg)
    t = [torch.as_tensor(a) for a in (q, k, v)]
    with pytest.raises(ValueError, match="bf16"):
        fused_edge_attention_nk(*t, s, r, m, tt)
    bf = [a.to(torch.bfloat16) for a in t]
    with pytest.raises(ValueError, match="NK layout"):
        fused_edge_attention_nk(*[a[:-128] for a in bf], s, r, m, tt)
    with pytest.raises(ValueError, match="one entry per slot"):
        fused_edge_attention_nk(*bf, s[:-1], r[:-1], m[:-1], tt)
    with pytest.raises(ValueError, match="contiguous"):
        fused_edge_attention_nk(bf[0].transpose(2, 3).contiguous().transpose(2, 3), *bf[1:],
                                s, r, m, tt)
