"""The port's graded-mesh training slice (CSR layout) against the JAX package.

On the 1,536-node graded test mesh (node N-1 is a real node with rows of
its own, so a padding row leaking into a sum would show), with the same
numpy inputs from a seed, edges compared per original edge
(``reduce_edges``) and nodes in the original order:
  (a) the plain CSR GraphNetBlock backward in fp32 (autograd of
      ``fused_gn_block_csr_reference``) matches ``jax.grad`` of
      ``blocked_reference`` within 1e-5 of max|ref| per gradient, for the
      folded, middle and last variants;
  (b) the port's bf16 CPU path under autograd matches ``jax.grad`` through
      the Pallas ``fused_gn_block`` in interpret mode (its ``_bwd_kernel``)
      within 0.03 of max|ref| (tests/test_fused_gnblock.py:172-189);
  (c) the same two checks for the attention: autograd of
      ``edge_attention`` in fp32 against JAX's ``edge_attention`` (1e-5 of
      max), and the bf16 CPU path against ``fused_edge_attention`` in
      interpret mode within 0.04 of max (tests/test_fused_edge_attention.py:
      80-85), with dq exactly 0 on receivers whose rows are all masked out;
  (d) ``sender_slots`` on the CSR row arrays lists every valid row once,
      under its sender, and no padding row (they point at sender 0, a real
      node with rows of its own), kept on the layout;
  (e) both ``torch.autograd.Function``s with their plain backwards give
      the plain autograd gradients, in the right order; the fp32 plain-path
      and the bf16 CSR-path train steps of both families against JAX's
      ``make_train_step`` (the JAX model built with ``edge_tiling``) through
      tests/test_torch_train_step.py's bounds, with no kernel launch;
  (f) ``entry.graded_train_setup`` and ``graded_transformer_train_setup``
      take two finite steps on the CPU.
The CUDA kernels themselves are tested on a card by tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from graph_physics_tpu.models.layers import MLP as FlaxMLP
from graph_physics_tpu.models.processors import EncodeProcessDecode as JaxEPD
from graph_physics_tpu.models.processors import EncodeTransformDecode as JETD
from graph_physics_tpu.ops.edge_attention import edge_attention as j_edge_attention
from graph_physics_tpu.ops.fused_edge_attention import fused_edge_attention as j_fused_attn
from graph_physics_tpu.ops.fused_gnblock import blocked_reference, fused_gn_block as j_fused_gn
from graph_physics_tpu_torch import entry
from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.ops import fused_edge_attention_csr as ea_ops
from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops
from graph_physics_tpu_torch.ops import fused_gnblock_csr as gn_ops
from graph_physics_tpu_torch.ops import tiling as ttiling
from graph_physics_tpu_torch.ops.edge_attention import edge_attention
from graph_physics_tpu_torch.ops.fused_gnblock_nk import _mlp_params
from graph_physics_tpu_torch.utils.gradcheck import grads_of
from tests import test_torch_simulator as epd_case
from tests import test_torch_transformer as tf_case
from tests.test_torch_csr_layout import graded_graph
from tests.test_torch_fused_gnblock_csr import FE, H, VARIANTS, _case
from tests.test_torch_graded import _packed, _frames
from tests.test_torch_layers import port_mlp
from tests.test_torch_train_step import check_bf16_steps, check_fp32_steps, run_steps


def _close_to_max(got, want, rel, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-3)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=rel, err_msg=name)


def _jax_mlp_grads(tree):
    """A flax MLP's gradient tree in the port's ``_mlp_params`` order, as
    torch lays the parameters out (kernels [out, in])."""
    n = len([k for k in tree if k.startswith("Dense_")])
    out = []
    for i in range(n):
        out += [np.asarray(tree[f"Dense_{i}"]["kernel"]).T, tree[f"Dense_{i}"]["bias"]]
    if "RMSNorm_0" in tree:
        out.append(tree["RMSNorm_0"]["scale"])
    return out


# ---- the CSR GraphNetBlock backward ------------------------------------------

#: a relu pre-activation this close to 0 may take either side in two fp32
#: computations that sum in different orders
KINK = 1e-6


def _away_from_kinks(c, cot_x, cot_edges):
    """The cotangents with zeros where the fp32 gradient has no one value: at
    every (edge, sample) whose encoder or edge MLP has a relu pre-activation
    within KINK of 0, at its receiver, and at every (node, sample) whose
    node MLP has one. There the gradient of a relu network is a matter of
    which side of the kink rounding lands on (passed in one computation,
    stopped in the other); with no cotangent reaching them, both sides give
    the same gradient."""
    tt = c["tt"]
    x, e = torch.as_tensor(c["x"]), torch.as_tensor(c["e_port"])
    s, r, m = c["senders"].long(), c["receivers"].long(), c["mask"]
    near_e = torch.zeros(e.shape[:2], dtype=torch.bool)
    with torch.no_grad():
        if c["enc"] is not None:
            enc = port_mlp(c["enc"], FE, H, H)
            near_e |= _pre_acts_near_kink(enc, e)
            e = enc(e)
        edge, node = port_mlp(c["ep"], 3 * H, H, H), port_mlp(c["np_"], 2 * H, H, H)
        h_in = torch.cat([e, x[r], x[s]], dim=-1)
        near_e |= _pre_acts_near_kink(edge, h_in)
        near_e &= m[:, None]
        eh = torch.where(m[:, None, None], edge(h_in), torch.zeros(()))
        agg = torch.zeros_like(x).index_add_(0, r, eh)
        near_x = _pre_acts_near_kink(node, torch.cat([x, agg], dim=-1))
        near_x |= torch.zeros_like(near_x).index_add_(0, r[m], near_e[m].to(near_x.dtype)) > 0
    cot_x = np.where(near_x.numpy()[..., None], 0.0, cot_x).astype(np.float32)
    gone = tt.reduce_edges(near_e.numpy(), c["e"])
    return cot_x, np.where(gone[..., None], 0.0, cot_edges).astype(np.float32)


def _pre_acts_near_kink(mlp, h):
    """Whether any relu pre-activation of ``mlp`` on ``h`` [..., in] (fp32)
    lies within KINK of 0, per row [...]."""
    near = torch.zeros(h.shape[:-1], dtype=torch.bool)
    for d in mlp.denses[:-1]:
        h = F.linear(h, d.weight) + d.bias
        near |= (h.abs() < KINK).any(-1)
        h = torch.relu(h)
    return near


def _gn_grads(c, seed, jax_block, jdtype, port_fn, tdtype, kink_free=False):
    """(port, JAX) gradients of Σ x_out·cot_x (+ Σ e_out·cot_e unless on the
    last block) for the block of case ``c``: dx, de per original edge
    unless the encoder is folded, then every MLP parameter (encoder, edge,
    node). The cotangents are drawn per original edge, so padding rows get
    none in either layout; ``kink_free`` zeroes them away from the relu
    kinks (:func:`_away_from_kinks`)."""
    rng = np.random.default_rng(seed)
    n, b = c["x"].shape[:2]
    cot_x = rng.normal(size=(n, b, H)).astype(np.float32)
    cot_edges = rng.normal(size=(c["e"], b, H)).astype(np.float32)
    if kink_free:
        cot_x, cot_edges = _away_from_kinks(c, cot_x, cot_edges)
    cj, ct = c["jt"].expand_edges(cot_edges), c["tt"].expand_edges(cot_edges)
    fold, last = c["enc"] is not None, c["last"]

    def jloss(x, e, enc, ep, np_):
        xo, eo = jax_block(x, e, enc, ep, np_)
        loss = jnp.sum(xo.astype(jnp.float32) * cot_x)
        return loss if last else loss + jnp.sum(eo.astype(jnp.float32) * cj)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(c["x"], jdtype), jnp.asarray(c["e_jax"], jdtype), c["enc"], c["ep"],
        c["np_"])
    want = [jg[0]] + ([] if fold else [c["jt"].reduce_edges(np.asarray(jg[1], np.float32),
                                                            c["e"])])
    for tree in ((jg[2],) if fold else ()) + (jg[3], jg[4]):
        want += _jax_mlp_grads(tree)

    mlps = (port_mlp(c["enc"], FE, H, H) if fold else None, port_mlp(c["ep"], 3 * H, H, H),
            port_mlp(c["np_"], 2 * H, H, H))
    x = torch.as_tensor(c["x"]).to(tdtype).requires_grad_(True)
    e = torch.as_tensor(c["e_port"]).to(tdtype).requires_grad_(not fold)
    xo, eo = port_fn(x, e, c["senders"], c["receivers"], c["mask"], mlps[1], mlps[2], c["tt"],
                     encoder_params=mlps[0], last_block=last)
    loss = (xo.float() * torch.as_tensor(cot_x)).sum()
    if not last:
        loss = loss + (eo.float() * torch.as_tensor(ct)).sum()
    wrt = [x] + ([] if fold else [e]) + [p for m in mlps if m is not None for p in _mlp_params(m)]
    tg = [g.float().numpy() for g in torch.autograd.grad(loss, wrt)]
    got = [tg[0]] + ([] if fold else [c["tt"].reduce_edges(tg[1], c["e"])]) + tg[2 - fold:]
    return got, want


@pytest.mark.parametrize("variant", VARIANTS)
def test_gn_plain_backward_fp32_matches_jax_grad_of_blocked_reference(variant):
    c = _case(variant, seed=3)

    def reference(x, e, enc, ep, np_):  # the folded encoder first, as a flax MLP
        if enc is not None:
            e = FlaxMLP(hidden_size=H, out_size=H, dtype=jnp.float32).apply({"params": enc}, e)
        return blocked_reference(x, e, ep, np_, c["jt"], compute_dtype=jnp.float32)

    got, want = _gn_grads(
        c, 4, reference, jnp.float32,
        lambda *a, **kw: gn_ops.fused_gn_block_csr_reference(*a, **kw,
                                                              compute_dtype=torch.float32),
        torch.float32, kink_free=True)
    assert len(got) == len(want) == 2 - (variant == "folded") + 9 * (3 if variant == "folded"
                                                                     else 2)
    for i, (a, w) in enumerate(zip(got, want)):
        _close_to_max(a, w, 1e-5, f"gradient {i}")


@pytest.mark.parametrize("variant", VARIANTS)
def test_gn_bf16_cpu_path_backward_matches_pallas_interpret(variant):
    c = _case(variant, seed=5)
    before = (gn_ops.fused_gn_block_csr.launches, gn_ops.fused_gn_block_csr.backward_launches)
    got, want = _gn_grads(
        c, 6, lambda x, e, enc, ep, np_: j_fused_gn(x, e, ep, np_, c["jt"], interpret=True,
                                                    edge_encoder_params=enc,
                                                    last_block=c["last"]),
        jnp.bfloat16, gn_ops.fused_gn_block_csr, torch.bfloat16)
    assert (gn_ops.fused_gn_block_csr.launches,
            gn_ops.fused_gn_block_csr.backward_launches) == before  # CPU: no launch
    for i, (a, w) in enumerate(zip(got, want)):
        _close_to_max(a, w, 0.03, f"gradient {i}")


@pytest.mark.parametrize("variant", VARIANTS)
def test_gn_function_with_plain_backward_matches_autograd(variant):
    """``_FusedGNBlockCSR`` with the plain pair standing in for the kernels
    routes every gradient to its input: bit for bit plain autograd."""
    c = _case(variant, seed=7)
    mlps = (port_mlp(c["enc"], FE, H, H) if c["enc"] is not None else None,
            port_mlp(c["ep"], 3 * H, H, H), port_mlp(c["np_"], 2 * H, H, H))
    params = [p for m in mlps if m is not None for p in _mlp_params(m)]
    rows = (c["senders"], c["receivers"], c["mask"])
    last = c["last"]

    def through(fn):
        def run(x, *e):
            e = e[0] if e else torch.as_tensor(c["e_port"]).to(torch.bfloat16)
            xo, eo = fn(x, e)
            return (xo if last else (xo, eo)), params
        return run

    gen = np.random.default_rng(8)
    inputs = [torch.as_tensor(c["x"]).to(torch.bfloat16)]
    if c["enc"] is None:
        inputs.append(torch.as_tensor(c["e_port"]).to(torch.bfloat16))
    n, b = c["x"].shape[:2]
    cots = [torch.as_tensor(gen.normal(size=(n, b, H))).to(torch.bfloat16)]
    if not last:
        cots.append(torch.as_tensor(gen.normal(size=(c["tt"].total_rows, b, H)))
                    .to(torch.bfloat16))
    got, _ = grads_of(through(lambda x, e: gn_ops.apply_with_backward(
        gn_ops.PLAIN, x, e, *rows, c["tt"], mlps, last)), inputs, cots)
    want, _ = grads_of(through(lambda x, e: gn_ops._reference_fwd(x, e, *rows, c["tt"], mlps,
                                                                   last)[:2]), inputs, cots)
    assert len(got) == len(want) == len(inputs) + len(params)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


# ---- the CSR attention backward ----------------------------------------------

B_ATTN, HEADS, DH = 2, 4, 16


def _attn_case(seed, empty):
    """q, k, v (numpy), the port's row mask and the JAX tiling with the rows
    of a few receivers (0, 5, N/2, N-1) masked out when ``empty``."""
    c = _case("middle")
    tt, jt = c["tt"], c["jt"]
    n = tt.num_nodes
    rng = np.random.default_rng(seed)
    qkv = [rng.normal(size=(n, B_ATTN, HEADS, DH)).astype(np.float32) for _ in range(3)]
    mask, jmask = c["mask"].clone(), jt.perm >= 0
    gone = np.array([0, 5, n // 2, n - 1]) if empty else np.zeros(0, np.int64)
    for r in gone:
        mask[tt.row_ptr[r]:tt.row_ptr[r + 1]] = False
        jmask &= ~np.isin(jt.perm, tt.perm[tt.row_ptr[r]:tt.row_ptr[r + 1]])
    if empty:  # JAX takes the edge set from its tiling: sentinel the masked slots
        sidx = np.where(jmask.reshape(jt.sidx.shape), jt.sidx, jt.window_rows)
        ridx = np.where(jmask.reshape(jt.ridx.shape), jt.ridx, jt.node_block)
        jt = dataclasses.replace(jt, sidx=sidx.astype(np.int32), ridx=ridx.astype(np.int32))
    return c, qkv, mask, jt, gone


def test_attention_plain_backward_fp32_matches_jax_grad():
    c, qkv, mask, _, _ = _attn_case(seed=11, empty=False)
    g = graded_graph()
    cot = np.random.default_rng(12).normal(size=qkv[0].shape).astype(np.float32)

    def jloss(q, k, v):
        out = j_edge_attention(q, k, v, jnp.asarray(g.senders), jnp.asarray(g.receivers),
                               jnp.asarray(g.edge_mask))
        return jnp.sum(out * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in qkv))
    got = ea_ops.edge_attention_backward_reference(
        *(torch.as_tensor(a) for a in qkv), c["senders"], c["receivers"], mask, c["tt"],
        torch.as_tensor(cot))
    for a, w, name in zip(got, want, ("dq", "dk", "dv")):
        _close_to_max(a.numpy(), w, 1e-5, name)


@pytest.mark.parametrize("empty", [False, True])
def test_attention_bf16_cpu_path_backward_matches_pallas_interpret(empty):
    c, qkv, mask, jt, gone = _attn_case(seed=13 + empty, empty=empty)
    cot = np.random.default_rng(15).normal(size=qkv[0].shape).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(j_fused_attn(q, k, v, jt, interpret=True).astype(jnp.float32) * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a, jnp.bfloat16) for a in qkv))
    leaves = [torch.as_tensor(a).to(torch.bfloat16).requires_grad_(True) for a in qkv]
    before = (ea_ops.fused_edge_attention_csr.launches,
              ea_ops.fused_edge_attention_csr.backward_launches)
    out = ea_ops.fused_edge_attention_csr(*leaves, c["senders"], c["receivers"], mask, c["tt"])
    got = torch.autograd.grad(out, leaves, torch.as_tensor(cot).to(torch.bfloat16))
    assert (ea_ops.fused_edge_attention_csr.launches,
            ea_ops.fused_edge_attention_csr.backward_launches) == before  # CPU: no launch
    for a, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert a.dtype == torch.bfloat16
        _close_to_max(a.float().numpy(), w, 0.04, name)
    assert (got[0][torch.as_tensor(gone)] == 0).all()
    assert gone.size == 4 * empty


def test_attention_function_with_plain_backward_matches_autograd():
    c, qkv, mask, _, _ = _attn_case(seed=16, empty=True)
    rows = (c["senders"], c["receivers"], mask)
    cot = torch.as_tensor(np.random.default_rng(17).normal(size=qkv[0].shape)).to(torch.bfloat16)
    inputs = [torch.as_tensor(a).to(torch.bfloat16) for a in qkv]
    got, _ = grads_of(lambda *t: (ea_ops.reference_with_backward(*t, *rows, c["tt"]), []),
                      inputs, [cot])
    want, _ = grads_of(lambda *t: (edge_attention(*t, *rows), []), inputs, [cot])
    for a, w in zip(got, want):
        assert torch.equal(a, w)


# ---- the transpose of the CSR rows -------------------------------------------

def test_sender_slots_transpose_the_csr_rows():
    c = _case("middle")
    senders, mask, tt = c["senders"], c["mask"], c["tt"]
    pad = ~mask
    assert pad.any() and (senders[pad] == 0).all()  # padding rows point at sender 0 ...
    assert ((senders == 0) & mask).any()  # ... which sends on real rows
    order, offsets = ttiling.cached_sender_slots(senders, mask, tt)
    assert int(offsets[-1]) == int(mask.sum())  # every valid row once, no padding row
    listed = order[:int(offsets[-1])].long()
    assert sorted(listed.tolist()) == torch.nonzero(mask).flatten().tolist()
    for j in range(tt.num_nodes):
        want = torch.nonzero((senders == j) & mask).flatten().tolist()
        assert order[offsets[j]:offsets[j + 1]].tolist() == want, j
    assert ttiling.cached_sender_slots(senders, mask, tt)[0] is order  # kept on the layout
    assert tt.derived["sender_slots"][3][0] is order


# ---- the train steps against JAX's -------------------------------------------

def _epd_steps(bf16, n_steps):
    c = _frames()
    if bf16:
        jg, tg = _packed(c["jt"], c["tt"])
        jmodel = JaxEPD(**dict(epd_case.KW, dtype=jnp.bfloat16, edge_tiling=c["jt"]))
    else:
        jg, _ = _packed()
        _, tg = _packed(tt=c["tt"])
        jmodel = JaxEPD(**dict(epd_case.KW, dtype=jnp.float32))
    dtype = torch.bfloat16 if bf16 else torch.float32
    tsim = entry.make_simulator(32, 2, dtype, c["tt"], seed=9)
    return run_steps(epd_case._jax_sim(jmodel), jg, tsim, MeshGraph.from_numpy(tg, "cpu"),
                     epd_case.PARAM, n_steps)


def _tf_steps(bf16, n_steps):
    c = _frames()
    kw = dict(message_passing_num=2, node_input_size=11, output_size=2, hidden_size=tf_case.H,
              num_heads=tf_case.HEADS)
    if bf16:
        jg, tg = _packed(c["jt"], c["tt"])
        jmodel = JETD(edge_tiling=c["jt"], dtype=jnp.bfloat16, **kw)
    else:
        jg, _ = _packed()
        _, tg = _packed(tt=c["tt"])
        jmodel = JETD(dtype=jnp.float32, **kw)
    dtype = torch.bfloat16 if bf16 else torch.float32
    tsim = entry.make_transformer_simulator(tf_case.H, 2, tf_case.HEADS, dtype, c["tt"], seed=9)
    return run_steps(tf_case._jax_sim(jmodel), jg, tsim, MeshGraph.from_numpy(tg, "cpu"),
                     tf_case.PARAM, n_steps)


@pytest.mark.parametrize("family", ["epd", "transformer"])
def test_train_step_fp32_plain_path_on_csr_graph_matches_jax(family):
    # Gradients 0 up to rounding take their sign from the order of the
    # sums, and Adam turns them into steps of ±lr: in the transformer the
    # key bias's (tests/test_torch_transformer_train.py); in ``epd`` here
    # one value of block 0's last edge Dense (4.3e-8 against a largest
    # 0.026 of that kernel), 1 of 33,314 values, which lands 1.65e-3 away.
    # The next step's loss then differs by 5.5e-5, beyond the 1e-5 bound,
    # so ``epd`` is held over its first step.
    if family == "epd":
        check_fp32_steps(_epd_steps(bf16=False, n_steps=1), noisy_share=1e-4, far_share=1e-4)
    else:
        check_fp32_steps(_tf_steps(bf16=False, n_steps=2), noisy_share=1e-3)


@pytest.mark.parametrize("family", ["epd", "transformer"])
def test_train_step_bf16_csr_path_matches_jax_fused(family):
    counts = ((gn_ops.fused_gn_block_csr,) if family == "epd"
              else (ea_ops.fused_edge_attention_csr, ffn_ops.fused_gated_ffn))
    before = [(f.launches, f.backward_launches) for f in counts]
    runs = (_epd_steps if family == "epd" else _tf_steps)(bf16=True, n_steps=2)
    assert [(f.launches, f.backward_launches) for f in counts] == before  # CPU: no launch
    check_bf16_steps(runs)


@pytest.mark.parametrize("setup_fn", [entry.graded_train_setup,
                                      entry.graded_transformer_train_setup])
def test_entry_graded_train_setups_take_steps_on_cpu(setup_fn):
    train = setup_fn("cpu", num_nodes=1500, batch=2, mp_steps=2)
    assert isinstance(train.tiling, ttiling.CSRLayout) and train.graph.x.shape[1] == 2
    assert len(train.simulator.model.processor_list) == 2
    stats = train.simulator._output_normalizer
    assert float(stats._acc_count) == 0  # fresh normalizer statistics
    gen = torch.Generator().manual_seed(0)
    losses = [train.train_step(train.state, train.graph, gen)["loss"].item() for _ in range(2)]
    assert train.state.step == 2 and all(np.isfinite(losses))
    for p in train.simulator.parameters():
        assert torch.isfinite(p).all()
