"""The port's edge attention at the head widths that had no kernel instance
before (8, 64 and 4 here), and a hidden-32, 4-head transformer, against
the JAX package, on the CPU.

  * on CPU tensors both wrappers (their plain version,
    ``ops.edge_attention.edge_attention`` on the layout's rows) match the
    Pallas kernels in interpret mode at head widths 8, 64 and 4 (B·heads·
    dh = 128, so the kernels' lanes fill), NK on the 14x10 mesh and CSR on
    the 1,536-node graded mesh: the output at rtol 0.03, atol 0.02
    (tests/test_fused_edge_attention_nk.py:96-99), and the plain backward
    (plain autograd, what stands in for the backward kernel) against
    ``jax.vjp`` of the Pallas kernel: dq, dk, dv within 0.04·max
    (tests/test_fused_edge_attention_nk.py:119-125); no launch is counted;
  * the world seam at head width 8, both layouts: the same with the world
    pieces of a sidecar (``world_parts``), dnum_w and dden_w included;
  * three bf16 train steps of a 2-block transformer at hidden 32 with 4
    heads (head width 8) on the NK layout, B=4 (both JAX kernels fuse:
    B·hidden = 128), against JAX's ``make_train_step`` on its fused path
    (Pallas in interpret mode) from the same weights, loaded through the
    weight bridge: the bounds of the ``epd`` slice's bf16 steps
    (tests/test_torch_train_step.py ``check_bf16_steps``).
The CUDA kernels at every head width dividing 128 are tested on a card by
tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.models.processors import EncodeTransformDecode as JETD
from graph_physics_tpu.ops import edge_attention as jea
from graph_physics_tpu.ops import tiling as jtiling
from graph_physics_tpu.ops.fused_edge_attention import fused_edge_attention as j_fused_csr
from graph_physics_tpu.ops.fused_edge_attention_nk import build_nk_tiling as j_build_nk
from graph_physics_tpu.ops.fused_edge_attention_nk import fused_edge_attention_nk as j_fused_nk
from graph_physics_tpu.training import packed as jpacked
from graph_physics_tpu_torch import entry
from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.ops import fused_edge_attention_csr as csr_ops
from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops
from graph_physics_tpu_torch.ops import tiling as ttiling
from graph_physics_tpu_torch.ops.edge_attention import world_attention_parts
from graph_physics_tpu_torch.ops.fused_edge_attention_csr import fused_edge_attention_csr
from graph_physics_tpu_torch.ops.fused_edge_attention_nk import fused_edge_attention_nk
from graph_physics_tpu_torch.training import packed as tpacked
from tests.helpers import tiny_graph
from tests.test_torch_fused_gnblock_csr import _layouts
from tests.test_torch_fused_gnblock_nk import _port_host_graph
from tests.test_torch_train_step import check_bf16_steps, run_steps
from tests.test_torch_transformer import _jax_sim
from tests.test_torch_world_attention import _sidecar

#: (batch, heads, head width): B·heads·dh = 128, the Pallas kernels' lanes
SHAPES = {8: (4, 4, 8), 64: (1, 2, 64), 4: (8, 4, 4)}
GRAD_REL = 0.04  # the JAX suite's gradient bound, |a - b| <= 0.04 · max|b|


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these small cases gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nk_layout():
    """The 14x10 mesh's NK layouts in both packages and the port's slot
    arrays (senders, receivers, edge_mask)."""
    g = tiny_graph(nx=14, ny=10)
    args = (np.asarray(g.senders), np.asarray(g.receivers), g.x.shape[0])
    jt = j_build_nk(*args, edge_mask=np.asarray(g.edge_mask), node_block=128)
    tt = ttiling.build_nk_tiling(*args, edge_mask=np.asarray(g.edge_mask))
    tg = ttiling.apply_to_graph_nk(_port_host_graph(g), tt)
    rows = tuple(torch.as_tensor(a) for a in (tg.senders, tg.receivers, tg.edge_mask))
    return dict(layout=tt, jt=jt, rows=rows, n_valid=int(g.n_node), op=fused_edge_attention_nk,
                j_kernel=j_fused_nk)


def _csr_layout():
    c = _layouts()
    return dict(layout=c["tt"], jt=c["jt"], rows=(c["senders"], c["receivers"], c["mask"]),
                n_valid=c["tt"].num_nodes, op=fused_edge_attention_csr, j_kernel=j_fused_csr)


LAYOUTS = {"nk": _nk_layout, "csr": _csr_layout}


def _qkv_cot(n, dh, seed):
    batch, heads, _ = SHAPES[dh]
    rng = np.random.default_rng(seed)
    return [((0.5 if i < 3 else 1.0) * rng.normal(size=(n, batch, heads, dh))).astype(np.float32)
            for i in range(4)]


def _bf16(*arrays):
    return [torch.as_tensor(a).to(torch.bfloat16) for a in arrays]


def _close_to_max(got, want, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(np.abs(want).max(), 1e-3)
    np.testing.assert_allclose(got / scale, want / scale, atol=GRAD_REL, err_msg=name)


@pytest.mark.parametrize("dh", [8, 64, 4])
@pytest.mark.parametrize("layout", ["nk", "csr"])
def test_plain_versions_match_pallas_interpret_at_new_head_widths(layout, dh):
    c = LAYOUTS[layout]()
    q, k, v, cot = _qkv_cot(c["layout"].num_nodes, dh, seed=dh + (layout == "csr"))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want, vjp = jax.vjp(lambda *t: c["j_kernel"](*t, c["jt"], interpret=True), jq, jk, jv)
    jgrads = vjp(jnp.asarray(cot, jnp.bfloat16))
    op = c["op"]
    before = op.launches, op.backward_launches
    qb, kb, vb, cb = _bf16(q, k, v, cot)
    with torch.no_grad():
        wrapped = op(qb, kb, vb, *c["rows"], c["layout"])
    leaves = [t.clone().requires_grad_(True) for t in (qb, kb, vb)]
    got = csr_ops.reference_with_backward(*leaves, *c["rows"], c["layout"])
    grads = torch.autograd.grad(got, leaves, cb)
    assert (op.launches, op.backward_launches) == before  # CPU tensors: the plain version
    assert torch.equal(wrapped, got)
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=0.03, atol=0.02)
    for name, a, b in zip(("dq", "dk", "dv"), grads, jgrads):
        _close_to_max(a.float().numpy(), b, name)


def _world_layout(layout):
    """The layout with every row of some receivers masked in both packages
    (JAX takes its edge set from the tiling: those slots get its
    sentinels), and the receivers stripped."""
    c = LAYOUTS[layout]()
    tt, jt = c["layout"], c["jt"]
    s, r, m = c["rows"]
    if layout == "nk":
        mask = m.numpy().reshape(tt.num_groups, tt.k_slots, tt.node_block).copy()
        mask[:, :, :3] = False
        gone = np.array([gi * tt.node_block + x for gi in range(tt.num_groups) for x in range(3)
                         if gi * tt.node_block + x < c["n_valid"]])
        sidx = np.where(mask.reshape(jt.sidx.shape), jt.sidx, jt.window_blocks * jt.window_unit)
        c["jt"] = dataclasses.replace(jt, sidx=sidx.astype(np.int32))
        mask = torch.as_tensor(mask.reshape(-1))
    else:
        mask, jmask = m.clone(), jt.perm >= 0
        gone = np.arange(3, tt.num_nodes, 97)
        for x in gone:
            mask[tt.row_ptr[x]:tt.row_ptr[x + 1]] = False
            jmask &= ~np.isin(jt.perm, tt.perm[tt.row_ptr[x]:tt.row_ptr[x + 1]])
        sidx = np.where(jmask.reshape(jt.sidx.shape), jt.sidx, jt.window_rows)
        ridx = np.where(jmask.reshape(jt.ridx.shape), jt.ridx, jt.node_block)
        c["jt"] = dataclasses.replace(jt, sidx=sidx.astype(np.int32), ridx=ridx.astype(np.int32))
    c.update(rows=(s, r, mask), gone=gone)
    return c


@pytest.mark.parametrize("layout", ["nk", "csr"])
def test_world_seam_matches_pallas_interpret_at_head_width_8(layout):
    c = _world_layout(layout)
    n, dh = c["layout"].num_nodes, 8
    batch = SHAPES[dh][0]
    q, k, v, cot = _qkv_cot(n, dh, seed=20 + (layout == "csr"))
    ws, wr, wm = _sidecar(c["n_valid"], n, 21, targets=c["gone"][::2], batch=batch)
    qb, kb, vb, cb = _bf16(q, k, v, cot)
    parts = world_attention_parts(qb, kb, vb, *(torch.as_tensor(a) for a in (ws, wr, wm)))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    jparts = jea.world_attention_parts(jq, jk, jv, *(jnp.asarray(a) for a in (ws, wr, wm)))

    def jkernel(q, k, v, nw, dw):
        return c["j_kernel"](q, k, v, c["jt"], interpret=True, world_parts=(nw, dw, jparts[2]))

    want, vjp = jax.vjp(jkernel, jq, jk, jv, *jparts[:2])
    jgrads = vjp(jnp.asarray(cot, jnp.bfloat16))
    op = c["op"]
    before = op.launches, op.backward_launches
    leaves = [t.clone().requires_grad_(True) for t in (qb, kb, vb, *parts[:2])]
    got = csr_ops.reference_with_backward(*leaves[:3], *c["rows"], c["layout"],
                                          world_parts=(*leaves[3:], parts[2]))
    grads = torch.autograd.grad(got, leaves, cb)
    with torch.no_grad():
        wrapped = op(qb, kb, vb, *c["rows"], c["layout"], world_parts=parts)
    assert (op.launches, op.backward_launches) == before
    assert torch.equal(wrapped, got)
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=0.03, atol=0.02)
    for name, a, b in zip(("dq", "dk", "dv", "dnum_w", "dden_w"), grads, jgrads):
        _close_to_max(a.float().numpy(), b, name)


def test_hidden_32_transformer_bf16_train_steps_match_jax_fused():
    """Hidden 32, 4 heads (head width 8), 2 blocks, B=4 frames of the 14x10
    mesh: JAX on its fused path (the blocked-CSR graph with both tilings,
    its attention on the NK kernel, its FFN on the fused kernel, Pallas in
    interpret mode), the port on the NK slot layout (on the CPU its
    wrappers take their plain versions)."""
    hidden, heads = 32, 4
    frames = [tiny_graph(nx=14, ny=10, frame=f) for f in range(4)]
    f0 = frames[0]
    args = (np.asarray(f0.senders), np.asarray(f0.receivers), int(f0.n_node))
    t = jtiling.build_edge_tiling(*args, edge_mask=np.asarray(f0.edge_mask), node_block=128)
    t_nk = j_build_nk(*args, edge_mask=np.asarray(f0.edge_mask), node_block=128)
    tt = ttiling.build_nk_tiling(*args, edge_mask=np.asarray(f0.edge_mask))
    assert t.num_nodes == t_nk.num_nodes == tt.num_nodes
    jframes = [jtiling.apply_to_graph(f, t).replace(tiling_idx=None) for f in frames]
    jg = jpacked.pack(jax.tree.map(lambda *xs: np.stack(xs), *jframes))
    ports = [ttiling.apply_to_graph_nk(_port_host_graph(f), tt) for f in frames]
    tg = MeshGraph.from_numpy(tpacked.pack(tpacked.stack(ports)), "cpu")
    kw = dict(message_passing_num=2, node_input_size=11, output_size=2, hidden_size=hidden,
              num_heads=heads)
    jsim = _jax_sim(JETD(edge_tiling=t, edge_tiling_nk=t_nk, dtype=jnp.bfloat16, **kw))
    tsim = entry.make_transformer_simulator(hidden, 2, heads, torch.bfloat16, tt, seed=9)
    param = {"model": {"type": "transformer", "message_passing_num": 2, "node_input_size": 2,
                       "edge_input_size": 0, "output_size": 2, "hidden_size": hidden,
                       "num_heads": heads}}
    counts = (fused_edge_attention_nk, ffn_ops.fused_gated_ffn)
    before = [(f.launches, f.backward_launches) for f in counts]
    runs = run_steps(jsim, jg, tsim, tg, param, 3)
    assert [(f.launches, f.backward_launches) for f in counts] == before  # CPU: no launch
    check_bf16_steps(runs)
