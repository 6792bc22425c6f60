"""The world seam of the port's edge attention against the JAX package.

The world-edge sidecar (per-sample world edges beside the static mesh
edges) joins each receiver's softmax through the pieces (num_w, den_w,
s_w) of ``world_attention_parts``:
  * ``world_attention_parts`` (packed [W, B] sidecar: one shift per
    (sample, head); one graph [W]: each receiver's own) and
    ``edge_attention`` with a sidecar match JAX's in fp32 to 1e-5, the
    gradients of q, k and v too;
  * the NK and CSR wrappers on CPU tensors, given the pieces (their plain
    version ``joint_edge_attention``, no launch), match the Pallas kernels
    with ``world_parts`` in interpret mode, bf16: the output at rtol 0.03,
    atol 0.02, and dq, dk, dv, dnum_w, dden_w (the port's through the
    ops' ``torch.autograd.Function`` with the plain backward, JAX's by
    ``jax.vjp`` of the kernel) to 0.04 · max|JAX's|
    (tests/test_fused_edge_attention_nk.py:96-99, :119-125); in fp32 the
    plain version with the port's pieces equals JAX's ``edge_attention``
    with the sidecar to 1e-5; receivers with world edges and no mesh row,
    receivers with neither (exact zeros) and masked world slots included;
  * the backward kernels take s_r (FlashAttention's D term) from the joint
    output, Σ_d inv·g_out·out: it equals the Pallas kernels' form,
    inv·(Σ_s p_s·abar_s + Σ_d num_w·w·gp), so the world's share needs no
    walk of its own.
The CUDA kernels' world seam is tested on a card by tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.ops import edge_attention as jea
from graph_physics_tpu.ops.fused_edge_attention import fused_edge_attention as j_fused_csr
from graph_physics_tpu.ops.fused_edge_attention_nk import fused_edge_attention_nk as j_fused_nk
from graph_physics_tpu_torch.ops import fused_edge_attention_csr as csr_ops
from graph_physics_tpu_torch.ops.segment import segment_max
from graph_physics_tpu_torch.ops.edge_attention import (
    edge_attention,
    joint_edge_attention,
    world_attention_parts,
)
from graph_physics_tpu_torch.ops.fused_edge_attention_csr import fused_edge_attention_csr
from graph_physics_tpu_torch.ops.fused_edge_attention_nk import (
    fused_edge_attention_nk,
    fused_edge_attention_nk_reference,
)
from tests.test_torch_edge_attention import _nk_case, _slots
from tests.test_torch_fused_gnblock_csr import _layouts

B, HEADS, DH = 2, 4, 16
W = 96
TOL = dict(rtol=1e-5, atol=1e-5)


def _sidecar(n_valid, n, seed, targets=(), batch=B, width=W):
    """A [W, B] sidecar: half the slots end at ``targets`` (when given),
    the rest at random valid nodes; every fifth slot masked, the last 8 the
    padding convention's (sender 0, receiver n - 1, masked)."""
    rng = np.random.default_rng(seed)
    send = rng.integers(0, n_valid, (width, batch))
    recv = rng.integers(0, n_valid, (width, batch))
    if len(targets):
        pick = rng.random((width, batch)) < 0.5
        recv = np.where(pick, np.asarray(targets)[rng.integers(0, len(targets), (width, batch))],
                        recv)
    mask = (np.arange(width) % 5 != 4)[:, None].repeat(batch, 1)
    send[-8:], recv[-8:], mask[-8:] = 0, n - 1, False
    return send.astype(np.int32), recv.astype(np.int32), mask


def _qkv(n, seed, batch=B, dh=DH):
    rng = np.random.default_rng(seed)
    return [(0.5 * rng.normal(size=(n, batch, HEADS, dh))).astype(np.float32) for _ in range(4)]


def _t(*arrays, dtype=None):
    out = [torch.as_tensor(a) for a in arrays]
    return [t.to(dtype) for t in out] if dtype is not None else out


def _j(*arrays, dtype=None):
    return [jnp.asarray(a, dtype) if dtype is not None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("packed", [True, False])
def test_world_attention_parts_match_jax_fp32(packed):
    n = 120
    q, k, v, _ = _qkv(n, 0)
    ws, wr, wm = _sidecar(100, n, 1)
    if not packed:
        q, k, v, ws, wr, wm = q[:, 0], k[:, 0], v[:, 0], ws[:, 0], wr[:, 0], wm[:, 0]
    got = world_attention_parts(*_t(q, k, v, ws, wr, wm))
    want = jea.world_attention_parts(*_j(q, k, v, ws, wr, wm))
    for name, a, b in zip(("num_w", "den_w", "s_w"), got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)
    if packed:  # one shift per (sample, head), the same at every receiver
        assert (got[2] == got[2][:1]).all()


def test_edge_attention_with_sidecar_matches_jax_fp32():
    """The joint softmax of the plain path, forward and the gradients of q,
    k, v, on the 14x10 mesh's edge list with a packed sidecar."""
    g, _, tt, _, q, k, v = _nk_case(seed=5)
    n = g.x.shape[0]
    q, k, v = q[:n], k[:n], v[:n]
    cot = np.random.default_rng(6).normal(size=q.shape).astype(np.float32)
    ws, wr, wm = _sidecar(int(g.n_node), n, 7)
    rows = (g.senders, g.receivers, g.edge_mask)

    def jloss(q, k, v):
        out = jea.edge_attention(q, k, v, *_j(*rows), wedge_senders=jnp.asarray(ws),
                                 wedge_receivers=jnp.asarray(wr), wedge_mask=jnp.asarray(wm))
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *_j(q, k, v))
    leaves = [t.requires_grad_(True) for t in _t(q, k, v)]
    got = edge_attention(*leaves, *_t(*rows), wedge_senders=torch.as_tensor(ws),
                         wedge_receivers=torch.as_tensor(wr), wedge_mask=torch.as_tensor(wm))
    grads = torch.autograd.grad(got, leaves, torch.as_tensor(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for name, a, b in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)


def _nk_world_case(seed):
    """The NK case with three receivers per node block stripped of their
    mesh slots, a sidecar reaching half of them, and both packages' slot
    or edge arrays."""
    g, jt, tt, tg, q, k, v = _nk_case(seed=seed)
    n = tt.num_nodes
    mask = np.asarray(tg.edge_mask).reshape(tt.num_groups, tt.k_slots, tt.node_block).copy()
    mask[:, :, :3] = False
    gone = np.array([gi * tt.node_block + r for gi in range(tt.num_groups) for r in range(3)
                     if gi * tt.node_block + r < int(g.n_node)])
    # JAX takes the edge set from its tiling: sentinel the stripped slots
    sidx = np.where(mask.reshape(jt.sidx.shape), jt.sidx, jt.window_blocks * jt.window_unit)
    jt = dataclasses.replace(jt, sidx=sidx.astype(np.int32))
    rows = _slots(tg)[:2] + (torch.as_tensor(mask.reshape(-1)),)
    return dict(n=n, n_valid=int(g.n_node), layout=tt, jt=jt, rows=rows, gone=gone,
                qkv=(q, k, v), op=fused_edge_attention_nk, j_kernel=j_fused_nk,
                plain=fused_edge_attention_nk_reference)


def _csr_world_case(seed):
    """The graded mesh's CSR case with every row of some receivers masked
    in both packages' layouts, and a sidecar reaching half of them."""
    c = _layouts()
    tt, jt = c["tt"], c["jt"]
    n = tt.num_nodes
    mask, jmask = c["mask"].clone(), jt.perm >= 0
    gone = np.arange(3, n, 97)
    for r in gone:
        mask[tt.row_ptr[r]:tt.row_ptr[r + 1]] = False
        jmask &= ~np.isin(jt.perm, tt.perm[tt.row_ptr[r]:tt.row_ptr[r + 1]])
    sidx = np.where(jmask.reshape(jt.sidx.shape), jt.sidx, jt.window_rows)
    ridx = np.where(jmask.reshape(jt.ridx.shape), jt.ridx, jt.node_block)
    jt = dataclasses.replace(jt, sidx=sidx.astype(np.int32), ridx=ridx.astype(np.int32))
    rng = np.random.default_rng(seed)
    qkv = [(0.5 * rng.normal(size=(n, B, HEADS, DH))).astype(np.float32) for _ in range(3)]
    return dict(n=n, n_valid=n, layout=tt, jt=jt, rows=(c["senders"], c["receivers"], mask),
                gone=gone, qkv=qkv, op=fused_edge_attention_csr, j_kernel=j_fused_csr,
                plain=lambda *a, world_parts: csr_ops.PLAIN[0](*a, world=world_parts))


CASES = {"nk": _nk_world_case, "csr": _csr_world_case}


@pytest.mark.parametrize("layout", ["nk", "csr"])
def test_plain_versions_with_world_parts_match_pallas_interpret_bf16(layout):
    c = CASES[layout](seed=11)
    n = c["n"]
    ws, wr, wm = _sidecar(c["n_valid"], n, 12, targets=c["gone"][::2])
    q, k, v = c["qkv"]
    cot = np.random.default_rng(13).normal(size=q.shape).astype(np.float32)
    qb, kb, vb = _t(q, k, v, dtype=torch.bfloat16)
    parts = world_attention_parts(qb, kb, vb, *_t(ws, wr, wm))
    jq, jk, jv = _j(q, k, v, dtype=jnp.bfloat16)
    jparts = jea.world_attention_parts(jq, jk, jv, *_j(ws, wr, wm))

    def jkernel(q, k, v, nw, dw):
        return c["j_kernel"](q, k, v, c["jt"], interpret=True, world_parts=(nw, dw, jparts[2]))

    want, vjp = jax.vjp(jkernel, jq, jk, jv, *jparts[:2])
    jgrads = vjp(jnp.asarray(cot, jnp.bfloat16))
    op = c["op"]
    before = op.launches, op.backward_launches
    leaves = [t.clone().requires_grad_(True) for t in (qb, kb, vb, *parts[:2])]
    got = csr_ops.reference_with_backward(*leaves[:3], *c["rows"], c["layout"],
                                          world_parts=(*leaves[3:], parts[2]))
    grads = torch.autograd.grad(got, leaves, torch.as_tensor(cot).to(torch.bfloat16))
    with torch.no_grad():
        wrapped = op(qb, kb, vb, *c["rows"], c["layout"], world_parts=parts)
    assert (op.launches, op.backward_launches) == before  # CPU tensors: the plain version
    assert torch.equal(wrapped, got)
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=0.03, atol=0.02)
    for name, a, b in zip(("dq", "dk", "dv", "dnum_w", "dden_w"), grads, jgrads):
        b = np.asarray(b, np.float32)
        scale = max(np.abs(b).max(), 1e-3)
        np.testing.assert_allclose(a.float().numpy() / scale, b / scale, atol=0.04,
                                   err_msg=name)
    # receivers with world edges and no mesh row get the world's softmax;
    # receivers with neither get exact zeros
    hit = np.zeros((n, B), bool)
    hit[wr[wm], np.nonzero(wm)[1]] = True
    has_rows = np.zeros(n, bool)
    has_rows[c["rows"][1][c["rows"][2]].numpy()] = True
    neither = torch.as_tensor(~has_rows[:, None] & ~hit)
    assert (hit & ~has_rows[:, None]).any() and neither.any()
    assert (got.detach()[neither] == 0).all()


@pytest.mark.parametrize("layout", ["nk", "csr"])
def test_plain_versions_with_world_parts_match_jax_fp32(layout):
    """fp32: the wrappers' plain versions with the port's pieces against
    JAX's edge_attention with the sidecar on the same edges (the stripped
    receivers' rows masked), forward and dq, dk, dv."""
    c = CASES[layout](seed=14)
    n, (s, r, m) = c["n"], c["rows"]
    ws, wr, wm = _sidecar(c["n_valid"], n, 15, targets=c["gone"][::2])
    q, k, v = c["qkv"]
    cot = np.random.default_rng(16).normal(size=q.shape).astype(np.float32)

    def jloss(q, k, v):
        out = jea.edge_attention(q, k, v, *_j(s.numpy(), r.numpy(), m.numpy()),
                                 wedge_senders=jnp.asarray(ws), wedge_receivers=jnp.asarray(wr),
                                 wedge_mask=jnp.asarray(wm))
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *_j(q, k, v))
    leaves = [t.requires_grad_(True) for t in _t(q, k, v)]
    parts = world_attention_parts(*leaves, *_t(ws, wr, wm))
    got = c["plain"](*leaves, s, r, m, c["layout"], world_parts=parts)
    grads = torch.autograd.grad(got, leaves, torch.as_tensor(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for name, a, b in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)


def test_s_r_from_the_joint_output_is_the_pallas_form():
    """Σ_d inv·g·out over the joint output equals inv·(Σ_s p_s·abar_s +
    Σ_d num_w·w·gp) (fused_edge_attention_nk.py:522-527), fp32."""
    c = _nk_world_case(seed=17)
    n = c["n"]
    s, r, m = c["rows"]
    q, k, v, g = _t(*c["qkv"], np.random.default_rng(18).normal(
        size=c["qkv"][0].shape).astype(np.float32))
    ws, wr, wm = _sidecar(c["n_valid"], n, 19, targets=c["gone"][::2])
    num_w, den_w, s_w = world_attention_parts(q, k, v, *_t(ws, wr, wm))
    out = joint_edge_attention(q, k, v, s, r, m, (num_w, den_w, s_w))
    rl = r.long()
    logits = (q[rl] * k[s.long()]).sum(-1) / DH ** 0.5
    m_j = torch.maximum(segment_max(logits, r, n, mask=m), s_w)
    p = torch.where(m[:, None, None], torch.exp(logits - m_j[rl]), torch.zeros(()))
    w = torch.exp(s_w - m_j)
    den = torch.zeros_like(s_w).index_add_(0, rl, p) + den_w * w
    inv = torch.where(den > 0, 1 / den, torch.zeros(()))
    gp = g * inv[..., None]
    s_r = (gp * out).sum(-1)
    abar = (v[s.long()] * gp[rl]).sum(-1)
    mesh = torch.zeros_like(s_r).index_add_(0, rl, p * abar)
    world = ((num_w * w[..., None]) * gp).sum(-1)
    np.testing.assert_allclose(s_r.numpy(), ((mesh + world) * inv).numpy(), rtol=1e-5,
                               atol=1e-6)
    assert (world != 0).any() and (mesh != 0).any()
