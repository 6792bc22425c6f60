"""The edge attention's kept softmax statistics and the kernels' formulas,
against the JAX package, in both edge layouts: the CSR rows of the graded
test mesh and the NK slots of the 14x10 cylinder mesh.

The forward kernels (csrc/ea_fwd.cuh, in fused_edge_attention_csr.cu and
fused_edge_attention_nk.cu) keep, under autograd, the max of each
receiver's logits and 1 / its softmax denominator; the backward kernels
(csrc/ea_bwd_passes.cuh) take them and the forward's output instead of
walking the rows again. A receiver's rows are its CSR rows or its K slots
at stride nb, masked ones among them, walked in row order. On the CPU,
with the same numpy inputs from a seed, for each layout:
  * ``softmax_stats``, the plain version of those statistics, on the
    layout's row arrays matches the same quantities built from JAX's
    segment ops on the original edge list
    (the max to 1e-6; 1/denominator to 5e-3 relative, since a logit one
    fp32 ulp apart can round its bf16 weight the other way, a change of
    up to 2^-8 of one term);
  * the kernels' formulas as the source headers state them (the forward's
    chunks of 4 rows with the online rescale, the backward's s_r from the
    output, p_s from the kept max), written out in torch here, match the
    layout's Pallas kernels (``fused_edge_attention``,
    ``fused_edge_attention_nk``) in interpret mode: the forward at rtol
    0.03, atol 0.02
    (tests/test_fused_edge_attention_nk.py:96-99) and dq, dk, dv within
    0.04 of max (tests/test_fused_edge_attention.py:80-85), with receivers
    whose rows (slots) are all masked out giving exact zeros; on a CSR hub
    receiver of
    300 rows (about 68 chunks) the forward formula on fp32 inputs matches the
    plain version within the rounding of p_s and the output to bf16
    (rtol 0.02, atol 0.01), its max exactly and its 1/denominator to 5e-3;
  * ``sender_places``, the transpose the backward's sender pass walks,
    gives every valid row (slot) one place inside its sender's range, with
    its receiver kept there.
The kernels themselves run on a card in tests/test_torch_cuda.py.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.ops import segment as jseg
from graph_physics_tpu.ops.fused_edge_attention import fused_edge_attention as j_fused_attn
from graph_physics_tpu.ops.fused_edge_attention_nk import fused_edge_attention_nk as j_fused_nk
from graph_physics_tpu_torch.ops import segment
from graph_physics_tpu_torch.ops.edge_attention import edge_attention
from graph_physics_tpu_torch.ops.fused_edge_attention_csr import sender_places, softmax_stats
from tests.test_torch_csr_layout import graded_graph
from tests.test_torch_csr_train import _attn_case, _close_to_max
from tests.test_torch_edge_attention import _nk_case

#: rows whose loads the kernels issue together (csrc/ea_common.cuh CHUNK)
CHUNK = 4
LAYOUTS = ("csr", "nk")


def _case(layout, seed, empty):
    """(rows, qkv, jax_attn, gone, g, layout object) of one layout: the row
    arrays (senders, receivers, mask) with every row of the receivers
    ``gone`` masked out when ``empty``; q, k, v (numpy); the layout's
    Pallas attention in interpret mode on bf16 q, k, v, with the same
    edges; the JAX host graph of the original edge list."""
    if layout == "csr":
        c, qkv, mask, jt, gone = _attn_case(seed=seed, empty=empty)
        g = graded_graph()
        rows = (c["senders"], c["receivers"], mask)
        return rows, qkv, lambda *t: j_fused_attn(*t, jt, interpret=True), gone, g, c["tt"]
    g, jt, tt, tg, q, k, v = _nk_case(seed=seed)
    senders, receivers = torch.as_tensor(tg.senders), torch.as_tensor(tg.receivers)
    mask = torch.as_tensor(tg.edge_mask).clone()
    n_real = int(g.n_node)
    gone = np.array([0, 5, n_real // 2, n_real - 1]) if empty else np.zeros(0, np.int64)
    jmask = jt.perm >= 0
    for r in gone:  # mask out every slot of these receivers in both layouts
        mask &= receivers != int(r)
        jmask &= ~np.isin(jt.perm, np.nonzero(np.asarray(g.receivers) == r)[0])
    # JAX takes the edge set from its tiling: sentinel the masked slots
    jt = dataclasses.replace(jt, sidx=np.where(jmask.reshape(jt.sidx.shape), jt.sidx,
                                               jt.window_rows).astype(np.int32))
    return ((senders, receivers, mask), [q, k, v],
            lambda *t: j_fused_nk(*t, jt, interpret=True), gone, g, tt)


def _bf(x):
    return x.to(torch.bfloat16).float()


def _logits(q, k, senders, receivers):
    dh = q.shape[-1]
    return (q.index_select(0, receivers).float() * k.index_select(0, senders).float()).sum(-1) \
        * (1.0 / math.sqrt(dh))


def forward_formula(q, k, v, senders, receivers, mask, chunk=CHUNK):
    """The forward kernel's output and statistics as its header states
    them: each receiver's valid rows in chunks of ``chunk``, p_s rounded to
    bf16 against the running max of the chunks so far, then rescaled to
    the final max."""
    n = q.shape[0]
    logits = _logits(q, k, senders, receivers)
    # each valid row's rank among its receiver's valid rows, in row order
    # (a CSR receiver's rows are contiguous, an NK receiver's at stride nb)
    rows = torch.nonzero(mask).flatten()
    order = torch.argsort(receivers[rows], stable=True)
    grouped = receivers[rows][order].long()
    count = torch.bincount(grouped, minlength=n)
    rank = torch.zeros(mask.numel(), dtype=torch.long)
    rank[rows[order]] = torch.arange(rows.numel()) - (torch.cumsum(count, 0) - count)[grouped]
    chunk_of = torch.where(mask, rank // chunk, -1)
    running = torch.full((n,) + logits.shape[1:], -math.inf)
    at_row = torch.full_like(logits, -math.inf)
    for c in range(int(chunk_of.max()) + 1):
        running = torch.maximum(running, segment.segment_max(logits, receivers, n,
                                                             mask=chunk_of == c))
        at_row = torch.where((chunk_of == c)[:, None, None], running.index_select(0, receivers),
                             at_row)
    m = running
    p = _bf(torch.exp(logits - at_row)) * torch.exp(at_row - m.index_select(0, receivers))
    den = segment.segment_sum(p, receivers, n, mask=mask)
    num = segment.segment_sum(p[..., None] * v.index_select(0, senders).float(), receivers, n,
                              mask=mask)
    out = torch.where(den[..., None] > 0, num / den.clamp_min(1e-30)[..., None], 0.0)
    inv = torch.where(den > 0, 1.0 / den.clamp_min(1e-30), 0.0)
    return _bf(out), m, inv


def backward_formula(q, k, v, senders, receivers, mask, out, m, inv, g_out):
    """dq, dk, dv as the backward kernel's header states them, from the
    forward's output and kept statistics."""
    n, dh = q.shape[0], q.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    q, k, v, out, g_out = (t.float() for t in (q, k, v, out, g_out))
    logits = _logits(q, k, senders, receivers)
    p = _bf(torch.exp(logits - m.index_select(0, receivers)))
    gp = _bf(g_out * inv[..., None])
    s_r = _bf((gp * out).sum(-1))
    abar = _bf((v.index_select(0, senders) * gp.index_select(0, receivers)).sum(-1))
    g = _bf(_bf(p * _bf(abar - s_r.index_select(0, receivers))) * scale)
    p, g = (torch.where(mask[:, None, None], t, 0.0) for t in (p, g))
    dq = segment.segment_sum(g[..., None] * k.index_select(0, senders), receivers, n)
    dk = segment.segment_sum(g[..., None] * q.index_select(0, receivers), senders, n)
    dv = segment.segment_sum(p[..., None] * gp.index_select(0, receivers), senders, n)
    return tuple(_bf(t) for t in (dq, dk, dv))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("empty", [False, True])
def test_softmax_stats_match_jax_segment_ops(empty, layout):
    rows, qkv, _, gone, g, lay = _case(layout, seed=31 + empty, empty=empty)
    n = lay.num_nodes
    q, k, _ = (torch.as_tensor(a) for a in qkv)
    m, inv = softmax_stats(q, k, *rows)

    # the same quantities from JAX's segment ops on the original edge list
    keep = np.ones(g.senders.shape[0], bool)
    for r in gone:  # the receivers whose rows the port's mask drops
        keep &= g.receivers != r
    send, recv = jnp.asarray(g.senders), jnp.asarray(g.receivers)
    emask = jnp.asarray(np.asarray(g.edge_mask) & keep)
    jq, jk = jnp.asarray(qkv[0]), jnp.asarray(qkv[1])
    logits = jnp.sum(jq[recv] * jk[send], -1) / math.sqrt(jq.shape[-1])
    jm = jseg.segment_max(logits, recv, n, emask)
    p = jnp.exp(logits - jm[recv]).astype(jnp.bfloat16).astype(jnp.float32)
    den = jseg.segment_sum(p, recv, n, emask)
    jinv = jnp.where(den > 0, 1.0 / jnp.where(den > 0, den, 1.0), 0.0)

    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(inv.numpy(), np.asarray(jinv), rtol=5e-3, atol=0)
    no_rows = (inv == 0).all(-1).all(-1).numpy()
    assert set(np.flatnonzero(no_rows)) >= set(gone.tolist())
    assert torch.isinf(m[torch.as_tensor(gone)]).all()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("empty", [False, True])
def test_kernel_formulas_match_pallas_interpret(empty, layout):
    rows, qkv, jax_attn, gone, _, _ = _case(layout, seed=33 + empty, empty=empty)
    q, k, v = (torch.as_tensor(a).to(torch.bfloat16) for a in qkv)
    cot = np.random.default_rng(35).normal(size=qkv[0].shape).astype(np.float32)
    jqkv = [jnp.asarray(a, jnp.bfloat16) for a in qkv]

    out, m, inv = forward_formula(q, k, v, *rows)
    want = jax_attn(*jqkv)
    np.testing.assert_allclose(out.numpy(), np.asarray(want, np.float32), rtol=0.03, atol=0.02)

    def jloss(q, k, v):
        return jnp.sum(jax_attn(q, k, v).astype(jnp.float32) * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*jqkv)
    got = backward_formula(q, k, v, *rows, out, m, inv, torch.as_tensor(cot).to(torch.bfloat16))
    for a, w, name in zip(got, want, ("dq", "dk", "dv")):
        _close_to_max(a.numpy(), w, 0.04, name)
    if empty:
        idx = torch.as_tensor(gone)
        assert (out[idx] == 0).all() and (got[0][idx] == 0).all()


def test_forward_formula_on_a_hub_receiver_matches_plain_version():
    rng = np.random.default_rng(37)
    n, hub, degree = 64, 3, 300
    receivers = np.sort(np.concatenate([np.full(degree, hub), rng.integers(0, n, 200)]))
    senders = rng.integers(0, n, receivers.size)
    mask = rng.random(receivers.size) > 0.1
    q, k, v = (torch.as_tensor(rng.normal(size=(n, 2, 4, 16)).astype(np.float32))
               for _ in range(3))
    rows = tuple(torch.as_tensor(a) for a in (senders.astype(np.int32),
                                              receivers.astype(np.int32), mask))
    out, m, inv = forward_formula(q, k, v, *rows)
    # fp32 inputs: only p's bf16 rounding separates the two
    want = edge_attention(q, k, v, *rows)
    torch.testing.assert_close(out, _bf(want), rtol=0.02, atol=0.01)
    sm, sinv = softmax_stats(q, k, *rows)
    assert torch.equal(m, sm)
    torch.testing.assert_close(inv, sinv, rtol=5e-3, atol=0)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("empty", [False, True])
def test_sender_places_transpose_the_csr_rows(empty, layout):
    """The backward's sender pass walks the valid rows (CSR rows or NK
    slots) by sender: each valid row has one place, inside its sender's
    range, and the receiver kept at that place is the row's; the places of
    the valid rows are 0 .. valid-1 once each."""
    (senders, receivers, mask), _, _, _, _, lay = _case(layout, seed=39, empty=empty)
    offsets, place, recv = sender_places(senders, receivers, mask, lay)
    rows = torch.nonzero(mask).flatten()
    at = place[rows].long()
    assert torch.equal(torch.sort(at).values, torch.arange(rows.numel()))
    j = senders[rows].long()
    assert ((offsets[j] <= at) & (at < offsets[j + 1])).all()
    assert torch.equal(recv[at], receivers[rows])
    assert offsets[-1] == rows.numel()
    assert sender_places(senders, receivers, mask, lay)[1] is place  # kept on the layout
