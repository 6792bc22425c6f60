"""Rows 1-4 at hidden 64 and 128 (the wide GraphNetBlock kernels' widths)
against the JAX package, on the CPU.

With the same numpy inputs from a seed, at B=2, on the 14x10 mesh's NK
layout (the slot layouts are equal in both packages) and on the 1,536-node
graded mesh's CSR layout (edges compared per original edge):
  * the plain versions ``fused_gn_block_nk_reference`` and
    ``fused_gn_block_csr_reference`` match ``blocked_reference_nk`` /
    ``blocked_reference`` in fp32 (1e-5), and their autograd matches
    ``jax.grad`` of them (1e-5 of each gradient's largest value, the
    cotangents zeroed where a relu pre-activation lies within 1e-6 of 0),
    for the folded-encoder, middle and last-block variants: the plain
    versions are width-generic;
  * the wrappers on CPU tensors (the plain versions in bf16, no launch)
    match the Pallas kernels in interpret mode at the JAX suite's 0.05,
    forward and gradients, one variant per layout and width;
  * the fused-path gate: hidden 24 and 48 take the plain path (they do not
    divide JAX's 128 lanes), and a bf16 NK ``EncodeProcessDecode`` at
    hidden 24 matches JAX's model within the plain path's bound;
  * MeshGraphNets' width: a 2-block ``EncodeProcessDecode`` at hidden 128
    loaded through ``load_jax_params`` matches JAX's forward and one train
    step in fp32 (the train-step suite's bounds), and its bf16 NK path
    matches JAX's fused path within 0.15; at 15 blocks a model loaded
    from JAX's format matches JAX's fp32 forward within 1e-4.
The CUDA kernels themselves are tested on a card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from graph_physics_tpu.models.layers import MLP as FlaxMLP
from graph_physics_tpu.models.processors import EncodeProcessDecode as JaxEPD
from graph_physics_tpu.ops.fused_edge_attention_nk import build_nk_tiling as j_build_nk
from graph_physics_tpu.ops.fused_gnblock import blocked_reference, fused_gn_block as j_fused
from graph_physics_tpu.ops.fused_gnblock_nk import blocked_reference_nk
from graph_physics_tpu.ops.fused_gnblock_nk import fused_gn_block_nk as j_fused_nk
from graph_physics_tpu.utils.convert import convert_state_dict
from graph_physics_tpu_torch import entry
from graph_physics_tpu_torch.models.layers import fused_path_ok
from graph_physics_tpu_torch.ops import tiling as ttiling
from graph_physics_tpu_torch.ops.fused_gnblock_csr import (
    fused_gn_block_csr,
    fused_gn_block_csr_reference,
)
from graph_physics_tpu_torch.ops.fused_gnblock_nk import (
    _mlp_params,
    fused_gn_block_nk,
    fused_gn_block_nk_reference,
)
from graph_physics_tpu_torch.utils.convert import load_jax_params
from tests.helpers import tiny_graph
from tests.test_torch_csr_train import _jax_mlp_grads
from tests.test_torch_fused_gnblock_csr import _layouts
from tests.test_torch_fused_gnblock_nk import _port_host_graph
from tests.test_torch_layers import np_mlp_params, port_mlp
from tests.test_torch_simulator import KW, PARAM, _jax_sim, _to_np
from tests.test_torch_train_step import _packed_graphs, check_fp32_steps, run_steps

WIDE = [64, 128]
VARIANTS = ["folded", "middle", "last"]
B, FE = 2, 3
#: a relu pre-activation this close to 0 may take either side in two fp32
#: computations that sum in different orders
KINK = 1e-6
_NK = {}


def _nk_layouts():
    """(JAX NKTiling, port NKTiling, port slot arrays) of the 14x10 mesh."""
    if not _NK:
        g = tiny_graph(nx=14, ny=10)
        args = (np.asarray(g.senders), np.asarray(g.receivers), g.x.shape[0])
        jt = j_build_nk(*args, edge_mask=np.asarray(g.edge_mask), node_block=128)
        tt = ttiling.build_nk_tiling(*args, edge_mask=np.asarray(g.edge_mask))
        tg = ttiling.apply_to_graph_nk(_port_host_graph(g), tt)
        _NK.update(jt=jt, tt=tt, senders=torch.as_tensor(tg.senders),
                   receivers=torch.as_tensor(tg.receivers), mask=torch.as_tensor(tg.edge_mask))
    return _NK


def _case(layout, h, variant, seed, batch=B, activation="relu"):
    """One block's inputs and parameters at hidden ``h`` and ``batch``
    samples, its MLPs with ``activation`` (the folded encoder relu): the
    NK layout's slot arrays (one edge input array for both packages), or
    the CSR layout's rows with each package's edge array expanded from the
    same per-edge values."""
    c = dict(_nk_layouts() if layout == "nk" else _layouts(), layout=layout, h=h, b=batch,
             act=activation)
    rng = np.random.default_rng(seed)
    n = c["tt"].num_nodes
    width = FE if variant == "folded" else h
    c["x"] = (0.5 * rng.normal(size=(n, batch, h))).astype(np.float32)
    if layout == "nk":
        c["e_jax"] = c["e_port"] = (0.5 * rng.normal(size=(c["tt"].total_rows, batch, width))
                                    ).astype(np.float32)
    else:
        edges = (0.5 * rng.normal(size=(c["e"], batch, width))).astype(np.float32)
        c["e_jax"], c["e_port"] = c["jt"].expand_edges(edges), c["tt"].expand_edges(edges)
    c.update(ep=np_mlp_params(rng, 3 * h, h, h), np_=np_mlp_params(rng, 2 * h, h, h),
             enc=np_mlp_params(rng, FE, h, h) if variant == "folded" else None,
             last=variant == "last")
    return c


def _mlps(c):
    """The port's (encoder or None, edge, node) MLPs of the case; the
    encoder keeps relu, as an ``epd``'s does."""
    h = c["h"]
    return (port_mlp(c["enc"], FE, h, h) if c["enc"] is not None else None,
            port_mlp(c["ep"], 3 * h, h, h, activation=c["act"]),
            port_mlp(c["np_"], 2 * h, h, h, activation=c["act"]))


def _port_fn(c, fn_nk, fn_csr, **kw):
    """The port's block of the case's layout as f(x, e, mlps, extra)."""
    rows = ((c["senders"], c["mask"]) if c["layout"] == "nk"
            else (c["senders"], c["receivers"], c["mask"]))
    fn = fn_nk if c["layout"] == "nk" else fn_csr

    def run(x, e, mlps, extra=None):
        return fn(x, e, *rows, mlps[1], mlps[2], c["tt"], encoder_params=mlps[0],
                  last_block=c["last"], extra_agg=extra, **kw)
    return run


def _jax_reference(c, cd):
    """blocked_reference(_nk) of the case, the folded encoder first as a
    flax MLP, as f(x, e, enc, ep, np_, extra)."""
    ref = blocked_reference_nk if c["layout"] == "nk" else blocked_reference

    def run(x, e, enc, ep, np_, extra=None):
        if enc is not None:
            e = FlaxMLP(hidden_size=c["h"], out_size=c["h"], dtype=cd).apply({"params": enc}, e)
        return ref(x, e, ep, np_, c["jt"], activation=c["act"], compute_dtype=cd,
                   extra_agg=extra)
    return run


def _jax_pallas(c):
    fused = j_fused_nk if c["layout"] == "nk" else j_fused

    def run(x, e, enc, ep, np_, extra=None):
        return fused(x, e, ep, np_, c["jt"], activation=c["act"], interpret=True,
                     edge_encoder_params=enc, last_block=c["last"], extra_agg=extra)
    return run


def _edges(c, a, port):
    """Per-edge values of an edge array: the NK slots as they are (one
    layout in both packages), the CSR rows per original edge."""
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)
    if c["layout"] == "nk":
        return a
    return (c["tt"] if port else c["jt"]).reduce_edges(a, c["e"])


def _close_to_max(got, want, rel, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-3)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=rel, err_msg=name)


@pytest.mark.parametrize("layout", ["nk", "csr"])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("hidden", WIDE)
def test_plain_forward_matches_blocked_reference_fp32(hidden, variant, layout):
    c = _case(layout, hidden, variant, seed=0)
    with torch.no_grad():
        tx, te = _port_fn(c, fused_gn_block_nk_reference, fused_gn_block_csr_reference,
                          compute_dtype=torch.float32)(
            torch.as_tensor(c["x"]), torch.as_tensor(c["e_port"]), _mlps(c))
    jx, je = _jax_reference(c, jnp.float32)(jnp.asarray(c["x"]), jnp.asarray(c["e_jax"]),
                                             c["enc"], c["ep"], c["np_"])
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5)
    if not c["last"]:
        np.testing.assert_allclose(_edges(c, te, True), _edges(c, je, False), rtol=1e-5,
                                   atol=1e-5)


def _pre_acts_near_kink(mlp, h):
    """Whether any relu pre-activation of ``mlp`` on ``h`` [..., in] (fp32)
    lies within KINK of 0, per row [...] (none without relu)."""
    near = torch.zeros(h.shape[:-1], dtype=torch.bool)
    if mlp.activation != "relu":
        return near
    for d in mlp.denses[:-1]:
        h = F.linear(h, d.weight) + d.bias
        near |= (h.abs() < KINK).any(-1)
        h = torch.relu(h)
    return near


def _cotangents(c, seed, extra=None):
    """Random cotangents of x_out and of e_out (per port row and per JAX
    row), zero where the fp32 gradient has no one value: at every (row,
    sample) whose encoder or edge MLP has a relu pre-activation within KINK
    of 0, at its receiver, and at every (node, sample) whose node MLP has
    one (tests/test_torch_csr_train.py:_away_from_kinks, on either
    layout). ``extra``: an extra aggregate [N, B, H] the block adds to its
    own before the node MLP."""
    rng = np.random.default_rng(seed)
    n, h, b = c["x"].shape[0], c["h"], c["b"]
    enc, edge, node = _mlps(c)
    x, e = torch.as_tensor(c["x"]), torch.as_tensor(c["e_port"])
    s, r, m = c["senders"].long(), c["receivers"].long(), c["mask"]
    near_e = torch.zeros(e.shape[:2], dtype=torch.bool)
    with torch.no_grad():
        if enc is not None:
            near_e |= _pre_acts_near_kink(enc, e)
            e = enc(e)
        h_in = torch.cat([e, x[r], x[s]], dim=-1)
        near_e |= _pre_acts_near_kink(edge, h_in)
        near_e &= m[:, None]
        eh = torch.where(m[:, None, None], edge(h_in), torch.zeros(()))
        agg = torch.zeros_like(x).index_add_(0, r, eh)
        if extra is not None:
            agg = agg + torch.as_tensor(extra)
        near_x = _pre_acts_near_kink(node, torch.cat([x, agg], dim=-1))
        near_x |= torch.zeros_like(near_x).index_add_(0, r[m], near_e[m].to(near_x.dtype)) > 0
    cot_x = np.where(near_x.numpy()[..., None], 0.0, rng.normal(size=(n, b, h)))
    if c["layout"] == "nk":
        cot_e = np.where(near_e.numpy()[..., None], 0.0,
                         rng.normal(size=(c["tt"].total_rows, b, h)))
        return cot_x.astype(np.float32), cot_e.astype(np.float32), cot_e.astype(np.float32)
    gone = c["tt"].reduce_edges(near_e.numpy(), c["e"])
    cot_edges = np.where(gone[..., None], 0.0, rng.normal(size=(c["e"], b, h)))
    cot_edges = cot_edges.astype(np.float32)
    return (cot_x.astype(np.float32), c["tt"].expand_edges(cot_edges),
            c["jt"].expand_edges(cot_edges))


def _grads(c, cots, jax_block, jdtype, port_block, tdtype):
    """(port, JAX) gradients of Σ x_out·cot_x (+ Σ e_out·cot_e unless on
    the last block): dx, de per edge unless the encoder is folded, then
    every MLP parameter (encoder, edge, node) in the port's order."""
    cot_x, cot_tp, cot_jx = cots
    fold, last = c["enc"] is not None, c["last"]

    def jloss(x, e, enc, ep, np_):
        xo, eo = jax_block(x, e, enc, ep, np_)
        loss = jnp.sum(xo.astype(jnp.float32) * cot_x)
        return loss if last else loss + jnp.sum(eo.astype(jnp.float32) * cot_jx)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(c["x"], jdtype), jnp.asarray(c["e_jax"], jdtype), c["enc"], c["ep"],
        c["np_"])
    want = [jg[0]] + ([] if fold else [_edges(c, jg[1], False)])
    for tree in ((jg[2],) if fold else ()) + (jg[3], jg[4]):
        want += _jax_mlp_grads(tree)

    mlps = _mlps(c)
    x = torch.as_tensor(c["x"]).to(tdtype).requires_grad_(True)
    e = torch.as_tensor(c["e_port"]).to(tdtype).requires_grad_(not fold)
    xo, eo = port_block(x, e, mlps)
    loss = (xo.float() * torch.as_tensor(cot_x)).sum()
    if not last:
        loss = loss + (eo.float() * torch.as_tensor(cot_tp)).sum()
    wrt = [x] + ([] if fold else [e]) + [p for m in mlps if m is not None for p in _mlp_params(m)]
    tg = [g.float().numpy() for g in torch.autograd.grad(loss, wrt)]
    got = [tg[0]] + ([] if fold else [_edges(c, tg[1], True)]) + tg[2 - fold:]
    return got, want


@pytest.mark.parametrize("layout", ["nk", "csr"])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("hidden", WIDE)
def test_plain_backward_matches_jax_grad_of_blocked_reference_fp32(hidden, variant, layout):
    c = _case(layout, hidden, variant, seed=1)
    got, want = _grads(c, _cotangents(c, seed=2), _jax_reference(c, jnp.float32), jnp.float32,
                       _port_fn(c, fused_gn_block_nk_reference, fused_gn_block_csr_reference,
                                compute_dtype=torch.float32), torch.float32)
    assert len(got) == len(want) == 2 - (variant == "folded") + 9 * (3 if variant == "folded"
                                                                     else 2)
    for i, (a, w) in enumerate(zip(got, want)):
        _close_to_max(a, w, 1e-5, f"gradient {i}")


@pytest.mark.parametrize("hidden,layout,variant", [
    (64, "nk", "folded"), (128, "nk", "middle"), (64, "csr", "middle"), (128, "csr", "last")])
def test_cpu_path_matches_pallas_interpret_bf16(hidden, layout, variant):
    """The wrapper's bf16 CPU path (no launch) against the Pallas kernels in
    interpret mode: outputs and gradients within the JAX suite's 0.05 of
    max (tests/test_fused_gnblock.py:172-189 holds its kernels to 0.03)."""
    c = _case(layout, hidden, variant, seed=3)
    block = _port_fn(c, fused_gn_block_nk, fused_gn_block_csr)
    counts = (fused_gn_block_nk.launches, fused_gn_block_nk.backward_launches,
              fused_gn_block_csr.launches, fused_gn_block_csr.backward_launches)
    with torch.no_grad():
        tx, te = block(torch.as_tensor(c["x"]).bfloat16(), torch.as_tensor(c["e_port"]).bfloat16(),
                       _mlps(c))
    jx, je = _jax_pallas(c)(jnp.asarray(c["x"], jnp.bfloat16),
                            jnp.asarray(c["e_jax"], jnp.bfloat16), c["enc"], c["ep"], c["np_"])
    assert tx.dtype == torch.bfloat16
    np.testing.assert_allclose(tx.float().numpy(), np.asarray(jx, np.float32), rtol=0.05,
                               atol=0.05)
    if not c["last"]:
        np.testing.assert_allclose(_edges(c, te, True), _edges(c, je, False), rtol=0.05,
                                   atol=0.05)
    got, want = _grads(c, _cotangents(c, seed=4), _jax_pallas(c), jnp.bfloat16, block,
                       torch.bfloat16)
    assert counts == (fused_gn_block_nk.launches, fused_gn_block_nk.backward_launches,
                      fused_gn_block_csr.launches, fused_gn_block_csr.backward_launches)
    for i, (a, w) in enumerate(zip(got, want)):
        _close_to_max(a, w, 0.05, f"gradient {i}")


# ---- the fused-path gate and whole models ------------------------------------

@pytest.mark.parametrize("hidden,fused", [(24, False), (48, False), (32, True), (64, True),
                                          (128, True)])
def test_fused_path_ok_requires_a_hidden_size_dividing_the_lanes(hidden, fused):
    """JAX's fused_path_ok(_nk) require LANES % hidden_size == 0
    (graph_physics_tpu/models/layers.py:668, :714); so does the port's."""
    t = _nk_layouts()["tt"]
    x = torch.zeros((t.num_nodes, B, hidden), dtype=torch.bfloat16)
    e = torch.zeros((t.total_rows, B, hidden), dtype=torch.bfloat16)
    raw = torch.zeros((t.total_rows, B, FE), dtype=torch.bfloat16)
    assert fused_path_ok(t, x, e, hidden, torch.bfloat16) is fused
    assert fused_path_ok(t, x, raw, hidden, torch.bfloat16, raw_edge=True) is fused
    csr = _layouts()["tt"]
    xc = torch.zeros((csr.num_nodes, B, hidden), dtype=torch.bfloat16)
    ec = torch.zeros((csr.total_rows, B, hidden), dtype=torch.bfloat16)
    assert fused_path_ok(csr, xc, ec, hidden, torch.bfloat16) is fused


def _jax_model(jgraph, model_kwargs):
    """tests/test_torch_simulator.py's _jax_setup with the parameter
    initialisation and the eval forward compiled (op by op they take most
    of these tests' time): the JAX Simulator's eval output, its params and
    normalizer statistics accumulated over ``jgraph``."""
    sim = _jax_sim(JaxEPD(**model_kwargs))
    g = jax.tree.map(jnp.asarray, jgraph)
    params = jax.jit(sim.init_params)(jax.random.PRNGKey(0), g)
    _, _, _, state = sim.prepare(sim.init_state(), g, is_training=True)
    out = jax.jit(lambda p, s, gg: sim.forward(p, s, gg, is_training=False))(params, state, g)
    return out, params, state


def _port_sim(hidden, params, state, dtype=torch.float32, tiling=None):
    sim = entry.make_simulator(hidden, 2, dtype, tiling, seed=9)
    load_jax_params(sim, _to_np(params), _to_np(state))
    return sim


@pytest.mark.parametrize("hidden,tol", [(24, 0.15), (128, 0.15)])
def test_bf16_nk_model_matches_jax(hidden, tol):
    """A 2-block bf16 ``EncodeProcessDecode`` on the NK layout, weights
    loaded from JAX: at hidden 24 both packages take the plain
    GraphNetBlock (no fused path, no launch), at hidden 128 both the fused
    path (the Pallas kernels in interpret mode in JAX, the plain versions
    here); the plain path's bound, 0.15 (tests/test_torch_simulator.py)."""
    jg, tg, jt, tt = _packed_graphs(nk=True)
    jout, params, state = _jax_model(jg, dict(KW, hidden_size=hidden, dtype=jnp.bfloat16,
                                               edge_tiling_nk=jt))
    tsim = _port_sim(hidden, params, state, torch.bfloat16, tt)
    fold = fused_path_ok(tt, torch.zeros((tt.num_nodes, 1, hidden), dtype=torch.bfloat16),
                         torch.zeros((tt.total_rows, 1, 3), dtype=torch.bfloat16), hidden,
                         torch.bfloat16, raw_edge=True)
    assert fold is (hidden == 128)
    tout = tsim.forward(tg, is_training=False)
    rows = tg.node_mask.numpy()
    for name in ("net_out", "outputs"):
        np.testing.assert_allclose(getattr(tout, name).numpy()[rows],
                                   np.asarray(getattr(jout, name))[rows], rtol=tol, atol=tol,
                                   err_msg=name)


def test_mgn_width_model_fp32_forward_and_train_step_match_jax():
    """MeshGraphNets' width (hidden 128) at 2 blocks, plain fp32 path:
    ``load_jax_params`` takes JAX's parameters and normalizer statistics;
    the forward within 1e-4 and one train step within the train-step
    suite's fp32 bounds (loss 1e-5, grad norm 1e-4, parameters 1e-5 but
    for 1e-4 of them, as below)."""
    jg, tg, _, _ = _packed_graphs(nk=False)
    kw = dict(KW, hidden_size=128)
    jout, params, state = _jax_model(jg, kw)
    tout = _port_sim(128, params, state).forward(tg, is_training=False)
    for name in ("net_out", "outputs"):
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    param = {"model": dict(PARAM["model"], hidden_size=128)}
    runs = run_steps(_jax_sim(JaxEPD(**kw)), jg, entry.make_simulator(128, 2, torch.float32,
                                                                       None, seed=9),
                     tg, param, 1, jit_init=True)
    # a gradient within fp32 rounding of 0 takes its sign from the sum
    # order, and Adam turns it into a step of up to lr (check_fp32_steps):
    # 1 of the 74k parameter values here (tests/test_torch_csr_train.py
    # allows 1e-4 of them at hidden 32)
    check_fp32_steps(runs, noisy_share=1e-4)


def test_load_jax_params_at_mgn_width_and_depth():
    """``load_jax_params`` takes a hidden-128, 15-block ``epd`` in JAX's
    format unchanged: a port model's weights and normalizer statistics
    converted by JAX's ``convert_state_dict`` (compiling JAX's 15-block
    initialisation would take most of this file's time) are loaded into a
    model with other weights, whose fp32 eval forward then matches JAX's
    on that tree within 1e-4."""
    jg, tg, _, _ = _packed_graphs(nk=False)
    source = entry.make_simulator(128, 15, torch.float32, None, seed=9)
    source.prepare(tg, is_training=True)
    param = {"model": dict(PARAM["model"], hidden_size=128, message_passing_num=15)}
    params, state = convert_state_dict(
        {k: v.detach().numpy().copy() for k, v in source.state_dict().items()}, param)
    jsim = _jax_sim(JaxEPD(**dict(KW, hidden_size=128, message_passing_num=15)))
    jout = jsim.forward(params, state, jax.tree.map(jnp.asarray, jg), is_training=False)
    sim = entry.make_simulator(128, 15, torch.float32, None, seed=3)
    load_jax_params(sim, _to_np(params), _to_np(state))
    tout = sim.forward(tg, is_training=False)
    for name in ("net_out", "outputs"):
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
