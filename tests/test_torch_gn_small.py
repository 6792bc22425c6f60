"""Rows 1-4 at hidden 16 to 1 (the GraphNetBlock widths under 32 that JAX
fuses) against the JAX package, on the CPU.

With the same numpy inputs from a seed, at B = 128 / hidden (B·H = 128,
so the Pallas kernels' lanes fill, as in JAX's suite), on the 14x10 mesh's
NK layout and on the 1,536-node graded mesh's CSR layout:
  * the plain versions ``fused_gn_block_nk_reference`` and
    ``fused_gn_block_csr_reference`` match ``blocked_reference_nk`` /
    ``blocked_reference`` in fp32 (1e-5), forward and autograd;
  * the wrappers on CPU tensors (the plain versions in bf16, no launch)
    match the Pallas kernels in interpret mode at the JAX suite's 0.05,
    forward and gradients: NK at hidden 16 (the edge encoder folded), 8,
    4 (not folded: JAX folds raw features no wider than hidden // 2) and
    1, CSR at 16 and 4, and the world seam (``extra_agg``) at 8. At hidden
    1 each MLP's RMSNorm tail gives ±scale, so the gradient of every Dense
    layer before it is 0 in exact arithmetic and rounding noise in both
    packages: those are held to 0.05 of the block's largest weight
    gradient, as tests/test_torch_ffn_small.py holds the hidden-1 FFN's
    norm2 scale;
  * the fused-path gate folds the encoder at 16 and 8 and not below;
  * one bf16 ``epd`` train step at hidden 16 on the NK layout (B=8),
    weights through ``load_jax_params``, against JAX's fused step.
The CUDA kernels are tested on a card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.models.processors import EncodeProcessDecode as JaxEPD
from graph_physics_tpu.ops import tiling as jtiling
from graph_physics_tpu.ops.fused_edge_attention_nk import build_nk_tiling as j_build_nk
from graph_physics_tpu.training import packed as jpacked
from graph_physics_tpu_torch import entry
from graph_physics_tpu_torch.core.graph import MeshGraph
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
from graph_physics_tpu_torch.training import packed as tpacked
from tests.helpers import tiny_graph
from tests.test_torch_csr_train import _jax_mlp_grads
from tests.test_torch_fused_gnblock_nk import _port_host_graph
from tests.test_torch_gn_wide import (
    FE,
    _case,
    _close_to_max,
    _cotangents,
    _edges,
    _jax_pallas,
    _jax_reference,
    _mlps,
    _nk_layouts,
    _port_fn,
)
from tests.test_torch_simulator import KW, PARAM, _jax_sim
from tests.test_torch_train_step import check_bf16_steps, run_steps


def case(layout, h, variant, seed, activation="relu", extra=False):
    """tests/test_torch_gn_wide.py's case at hidden ``h`` and B = 128 / h,
    its MLPs with ``activation``; with ``extra`` a node-aligned extra
    aggregate (drawn after the case's values)."""
    c = _case(layout, h, variant, seed, batch=128 // h, activation=activation)
    c["extra"] = None
    if extra:
        rng = np.random.default_rng(seed + 1000)
        c["extra"] = (0.5 * rng.normal(size=c["x"].shape)).astype(np.float32)
    return c


def cotangents(c, seed):
    """tests/test_torch_gn_wide.py's cotangents of the case, with its extra
    aggregate."""
    return _cotangents(c, seed, extra=c["extra"])


def grads(c, cots, jax_block, jdtype, port_block, tdtype):
    """(port, JAX, names) gradients of Σ x_out·cot_x (+ Σ e_out·cot_e unless
    on the last block): dx, de per edge unless the encoder is folded, dea
    with an extra aggregate, then every MLP parameter (encoder, edge,
    node) in the port's order."""
    cot_x, cot_tp, cot_jx = cots
    fold, last, has_extra = c["enc"] is not None, c["last"], c["extra"] is not None

    def jloss(x, e, enc, ep, np_, extra):
        xo, eo = jax_block(x, e, enc, ep, np_, extra)
        loss = jnp.sum(xo.astype(jnp.float32) * cot_x)
        return loss if last else loss + jnp.sum(eo.astype(jnp.float32) * cot_jx)

    jextra = None if not has_extra else jnp.asarray(c["extra"], jdtype)
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4, 5))(
        jnp.asarray(c["x"], jdtype), jnp.asarray(c["e_jax"], jdtype), c["enc"], c["ep"],
        c["np_"], jextra)
    want = ([jg[0]] + ([] if fold else [_edges(c, jg[1], False)])
            + ([jg[5]] if has_extra else []))
    names = ["dx"] + ([] if fold else ["de"]) + (["dea"] if has_extra else [])
    for tag, tree in (((("enc", jg[2]),) if fold else ()) + (("edge", jg[3]), ("node", jg[4]))):
        g = _jax_mlp_grads(tree)
        want += g
        names += [f"{tag}.{i}" for i in range(len(g))]

    ms = _mlps(c)
    x = torch.as_tensor(c["x"]).to(tdtype).requires_grad_(True)
    e = torch.as_tensor(c["e_port"]).to(tdtype).requires_grad_(not fold)
    extra = None if not has_extra else torch.as_tensor(c["extra"]).to(tdtype).requires_grad_(True)
    xo, eo = port_block(x, e, ms, extra)
    loss = (xo.float() * torch.as_tensor(cot_x)).sum()
    if not last:
        loss = loss + (eo.float() * torch.as_tensor(cot_tp)).sum()
    wrt = ([x] + ([] if fold else [e]) + ([extra] if has_extra else [])
           + [p for m in ms if m is not None for p in _mlp_params(m)])
    tg = [g.float().numpy() for g in torch.autograd.grad(loss, wrt)]
    got = [tg[0]] + ([] if fold else [_edges(c, tg[1], True)]) + tg[2 - fold:]
    return got, want, names


def check_grads(c, got, want, names, rel):
    """Each gradient within ``rel`` of its largest value; at hidden 1 the
    Dense gradients before each RMSNorm tail (0 in exact arithmetic,
    rounding noise in both packages) within ``rel`` of the block's largest
    weight gradient."""
    floor = 0.0
    if c["h"] == 1:
        floor = max(float(np.abs(np.asarray(w, np.float32)).max())
                    for w, n in zip(want, names) if "." in n)
    counts = {}
    for n in names:
        counts[n.split(".")[0]] = counts.get(n.split(".")[0], 0) + 1
    for a, w, name in zip(got, want, names):
        tag, _, i = name.partition(".")
        noise = c["h"] == 1 and i and int(i) < counts[tag] - 1  # all but the scale
        if noise:
            w = np.asarray(w, np.float32)
            scale = max(np.abs(w).max(), floor)
            np.testing.assert_allclose(np.asarray(a, np.float32) / scale, w / scale, rtol=0,
                                       atol=rel, err_msg=name)
        else:
            _close_to_max(a, w, rel, name)


def _port_out(c, fn_nk, fn_csr, dtype, **kw):
    extra = None if c["extra"] is None else torch.as_tensor(c["extra"]).to(dtype)
    with torch.no_grad():
        return _port_fn(c, fn_nk, fn_csr, **kw)(torch.as_tensor(c["x"]).to(dtype),
                                                 torch.as_tensor(c["e_port"]).to(dtype),
                                                 _mlps(c), extra)


def check_against_pallas(c, seed):
    """The wrapper's bf16 CPU path (no launch) against the Pallas kernel in
    interpret mode: outputs and gradients within the JAX suite's 0.05."""
    counts = (fused_gn_block_nk.launches, fused_gn_block_nk.backward_launches,
              fused_gn_block_csr.launches, fused_gn_block_csr.backward_launches)
    tx, te = _port_out(c, fused_gn_block_nk, fused_gn_block_csr, torch.bfloat16)
    jextra = None if c["extra"] is None else jnp.asarray(c["extra"], jnp.bfloat16)
    jx, je = _jax_pallas(c)(jnp.asarray(c["x"], jnp.bfloat16),
                           jnp.asarray(c["e_jax"], jnp.bfloat16), c["enc"], c["ep"], c["np_"],
                           jextra)
    assert tx.dtype == torch.bfloat16
    np.testing.assert_allclose(tx.float().numpy(), np.asarray(jx, np.float32), rtol=0.05,
                               atol=0.05)
    if not c["last"]:
        np.testing.assert_allclose(_edges(c, te, True), _edges(c, je, False), rtol=0.05,
                                   atol=0.05)
    got, want, names = grads(c, cotangents(c, seed), _jax_pallas(c), jnp.bfloat16,
                             _port_fn(c, fused_gn_block_nk, fused_gn_block_csr), torch.bfloat16)
    assert counts == (fused_gn_block_nk.launches, fused_gn_block_nk.backward_launches,
                      fused_gn_block_csr.launches, fused_gn_block_csr.backward_launches)
    check_grads(c, got, want, names, 0.05)


@pytest.mark.parametrize("layout,hidden,variant", [
    ("nk", 8, "middle"), ("nk", 1, "last"), ("csr", 4, "folded")])
def test_plain_forward_matches_blocked_reference_fp32(layout, hidden, variant):
    c = case(layout, hidden, variant, seed=0)
    tx, te = _port_out(c, fused_gn_block_nk_reference, fused_gn_block_csr_reference,
                       torch.float32, compute_dtype=torch.float32)
    jx, je = _jax_reference(c, jnp.float32)(jnp.asarray(c["x"]), jnp.asarray(c["e_jax"]),
                                            c["enc"], c["ep"], c["np_"])
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5)
    if not c["last"]:
        np.testing.assert_allclose(_edges(c, te, True), _edges(c, je, False), rtol=1e-5,
                                   atol=1e-5)


def test_plain_backward_matches_jax_grad_of_blocked_reference_fp32():
    layout, hidden, variant = "nk", 4, "middle"
    c = case(layout, hidden, variant, seed=1)
    got, want, names = grads(c, cotangents(c, seed=2), _jax_reference(c, jnp.float32),
                             jnp.float32,
                             _port_fn(c, fused_gn_block_nk_reference,
                                      fused_gn_block_csr_reference, compute_dtype=torch.float32),
                             torch.float32)
    for a, w, name in zip(got, want, names):
        _close_to_max(a, w, 1e-5, name)


@pytest.mark.parametrize("layout,hidden,variant", [
    ("nk", 16, "folded"), ("nk", 8, "middle"), ("nk", 4, "middle"), ("nk", 1, "last"),
    ("csr", 16, "middle"), ("csr", 4, "last")])
def test_cpu_path_matches_pallas_interpret_bf16(layout, hidden, variant):
    """Rows 1-4's plain versions against the Pallas kernels at the small
    widths (hidden 4's first block takes encoded edges, so its case is a
    block on hidden-wide edges, as ``middle``)."""
    check_against_pallas(case(layout, hidden, variant, seed=3), seed=4)


def test_world_seam_at_hidden_8_matches_pallas_interpret_bf16():
    """The extra aggregate (``extra_agg``, the world edges') at hidden 8, NK:
    x_out, e_out and the gradients, dea included, within 0.05 of the
    Pallas kernel's."""
    check_against_pallas(case("nk", 8, "middle", seed=5, extra=True), seed=6)


@pytest.mark.parametrize("hidden,folds", [(16, True), (8, True), (4, False), (2, False),
                                          (1, False)])
def test_fused_path_folds_the_encoder_where_jax_does(hidden, folds):
    """Every width dividing 128 takes the fused path; the 3 raw edge
    features fold into the first block only where they are no wider than
    hidden // 2 (graph_physics_tpu/models/layers.py:673, :719)."""
    t = _nk_layouts()["tt"]
    x = torch.zeros((t.num_nodes, 2, hidden), dtype=torch.bfloat16)
    e = torch.zeros((t.total_rows, 2, hidden), dtype=torch.bfloat16)
    raw = torch.zeros((t.total_rows, 2, FE), dtype=torch.bfloat16)
    assert fused_path_ok(t, x, e, hidden, torch.bfloat16)
    assert fused_path_ok(t, x, raw, hidden, torch.bfloat16, raw_edge=True) is folds


def test_epd_train_step_at_hidden_16_matches_jax_fused():
    """One bf16 ``epd`` train step at hidden 16 (2 blocks, the encoder
    folded) on the NK layout, B=8 (B·H = 128, so JAX takes its fused path:
    the Pallas kernels in interpret mode), from JAX's weights loaded
    through ``load_jax_params``: the bf16 train-step suite's bounds, and no
    launch on the CPU."""
    frames = [tiny_graph(nx=14, ny=10, frame=f, num_steps=9) for f in range(8)]
    n = frames[0].x.shape[0]
    args = (np.asarray(frames[0].senders), np.asarray(frames[0].receivers), n)
    jt = j_build_nk(*args, edge_mask=np.asarray(frames[0].edge_mask), node_block=128)
    tt = ttiling.build_nk_tiling(*args, edge_mask=np.asarray(frames[0].edge_mask))
    jframes = [jtiling.apply_to_graph_nk(f, jt) for f in frames]
    ports = [ttiling.apply_to_graph_nk(_port_host_graph(f), tt) for f in frames]
    jg = jpacked.pack(jax.tree.map(lambda *xs: np.stack(xs), *jframes))
    tg = MeshGraph.from_numpy(tpacked.pack(tpacked.stack(ports)), "cpu")
    jsim = _jax_sim(JaxEPD(**dict(KW, hidden_size=16, dtype=jnp.bfloat16, edge_tiling_nk=jt)))
    tsim = entry.make_simulator(16, 2, torch.bfloat16, tt, seed=9)
    param = {"model": dict(PARAM["model"], hidden_size=16)}
    before = (fused_gn_block_nk.launches, fused_gn_block_nk.backward_launches)
    runs = run_steps(jsim, jg, tsim, tg, param, 1)
    assert (fused_gn_block_nk.launches, fused_gn_block_nk.backward_launches) == before
    check_bf16_steps(runs)
