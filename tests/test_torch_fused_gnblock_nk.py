"""The port's NK slot layout and fused GraphNetBlock against the JAX package.

  * the NK layout (slot order, padding) equals the JAX package's;
  * the plain PyTorch version ``fused_gn_block_nk_reference`` matches
    ``blocked_reference_nk`` in fp32 (1e-5) for the folded-encoder, middle
    and last-block variants, and the Pallas kernel run in interpret mode in
    bf16 (rtol = atol = 0.05, the JAX suite's bound for the same check);
  * on CPU tensors the wrapper takes the plain version and counts no launch;
  * the plain version of the backward kernel,
    ``fused_gn_block_nk_backward_reference``, matches ``jax.grad`` of
    ``blocked_reference_nk`` in fp32 (1e-5 of each gradient's largest
    value, away from relu kinks) and of the Pallas kernel in interpret mode
    in bf16 (0.04 of each gradient's largest value), on a mesh whose node
    N-1 owns valid slots and whose masked slots sit between valid slots of
    the same receiver.
The CUDA kernel itself is tested on a card by tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.models.layers import MLP as FlaxMLP
from graph_physics_tpu.ops import tiling as jtiling
from graph_physics_tpu.ops.fused_edge_attention_nk import build_nk_tiling as j_build_nk
from graph_physics_tpu.ops.fused_gnblock_nk import blocked_reference_nk, fused_gn_block_nk as j_fused
from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.ops import tiling as ttiling
from graph_physics_tpu_torch.ops.fused_gnblock_nk import (
    _reference_parts,
    fused_gn_block_nk,
    fused_gn_block_nk_backward_reference,
    fused_gn_block_nk_reference,
)
from tests.helpers import tiny_graph
from tests.test_torch_layers import np_mlp_params, port_mlp

H, B, FE = 32, 4, 3
VARIANTS = ["folded", "middle", "last"]


def _port_host_graph(g):
    """The JAX package's host MeshGraph as a port host MeshGraph."""
    return MeshGraph(x=g.x, pos=g.pos, node_type=g.node_type, node_mask=g.node_mask,
                     senders=g.senders, receivers=g.receivers, edge_mask=g.edge_mask,
                     edge_attr=g.edge_attr, y=g.y, n_node=int(g.n_node))


@pytest.mark.parametrize("nx,ny", [(14, 10), (20, 16)])
def test_nk_layout_matches_jax(nx, ny):
    g = tiny_graph(nx=nx, ny=ny)
    args = (np.asarray(g.senders), np.asarray(g.receivers), int(g.n_node))
    jt = j_build_nk(*args, edge_mask=np.asarray(g.edge_mask), node_block=128)
    tt = ttiling.build_nk_tiling(*args, edge_mask=np.asarray(g.edge_mask))
    assert jt is not None and tt is not None
    np.testing.assert_array_equal(tt.perm, jt.perm)
    assert (tt.k_slots, tt.node_block, tt.num_nodes) == (jt.k_slots, jt.node_block, jt.num_nodes)
    jg = jtiling.apply_to_graph_nk(g, jt)
    tg = ttiling.apply_to_graph_nk(_port_host_graph(g), tt)
    for name in ("x", "pos", "node_type", "node_mask", "senders", "receivers", "edge_mask",
                 "edge_attr", "y"):
        np.testing.assert_array_equal(np.asarray(getattr(tg, name)),
                                      np.asarray(getattr(jg, name)), err_msg=name)
    # slot s of receiver block g holds receiver g·nb + s % nb (k-major)
    valid = tg.edge_mask
    gids, loc_r = ttiling.nk_row_maps(tt)
    np.testing.assert_array_equal(tg.receivers[valid], (gids * tt.node_block + loc_r)[valid])
    vals = np.random.default_rng(0).normal(size=(g.senders.shape[0], 2))
    back = tt.reduce_edges(tt.expand_edges(vals), len(vals))
    e = int(g.n_edge)  # valid edges are a prefix; padded edges own no slot
    np.testing.assert_array_equal(back[:e], vals[:e])
    assert not back[e:].any()


def _case(variant, seed=0, nx=14, ny=10, holes=False, n_pad=None):
    """Inputs and parameters of one block on the nx x ny mesh's NK layout.
    With ``holes``, slot k=1 of every third receiver whose slot k=2 is
    valid is masked out in both packages' layouts, so masked slots sit
    between valid slots of the same receiver."""
    g = tiny_graph(nx=nx, ny=ny, n_pad=n_pad)
    tt = ttiling.build_nk_tiling(g.senders, g.receivers, g.x.shape[0], edge_mask=g.edge_mask)
    jt = j_build_nk(np.asarray(g.senders), np.asarray(g.receivers), g.x.shape[0],
                    edge_mask=np.asarray(g.edge_mask), node_block=128)
    if holes:
        kk, nb = tt.k_slots, tt.node_block
        perm = tt.perm.copy().reshape(-1, kk, nb)
        hole = (perm[:, 2] >= 0) & (np.arange(nb) % 3 == 0)
        perm[:, 1][hole] = -1
        sidx = jt.sidx.copy().reshape(-1, kk, nb)
        sidx[:, 1][hole] = jt.window_rows  # the JAX layout's padding sentinel
        tt = dataclasses.replace(tt, perm=perm.reshape(-1), derived={})
        jt = dataclasses.replace(jt, perm=perm.reshape(-1), sidx=sidx.reshape(jt.sidx.shape))
    tg = ttiling.apply_to_graph_nk(_port_host_graph(g), tt)
    rng = np.random.default_rng(seed)
    n, rows = tt.num_nodes, tt.total_rows
    x = (0.5 * rng.normal(size=(n, B, H))).astype(np.float32)
    width = FE if variant == "folded" else H
    e = (0.5 * rng.normal(size=(rows, B, width))).astype(np.float32)
    ep, np_ = np_mlp_params(rng, 3 * H, H, H), np_mlp_params(rng, 2 * H, H, H)
    enc = np_mlp_params(rng, FE, H, H) if variant == "folded" else None
    return dict(tt=tt, jt=jt, senders=torch.as_tensor(tg.senders),
                mask=torch.as_tensor(tg.edge_mask), x=x, e=e, ep=ep, np_=np_, enc=enc,
                last=variant == "last")


def _port_call(c, fn, dtype, **kw):
    enc = port_mlp(c["enc"], FE, H, H) if c["enc"] is not None else None
    with torch.no_grad():
        return fn(torch.as_tensor(c["x"]).to(dtype), torch.as_tensor(c["e"]).to(dtype),
                  c["senders"], c["mask"], port_mlp(c["ep"], 3 * H, H, H),
                  port_mlp(c["np_"], 2 * H, H, H), c["tt"], encoder_params=enc,
                  last_block=c["last"], **kw)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


@pytest.mark.parametrize("variant", VARIANTS)
def test_reference_matches_blocked_reference_nk_fp32(variant):
    c = _case(variant)
    e = jnp.asarray(c["e"])
    if c["enc"] is not None:  # the folded block: encoder first, as an XLA MLP
        e = FlaxMLP(hidden_size=H, out_size=H).apply({"params": c["enc"]}, e)
    jx, je = blocked_reference_nk(jnp.asarray(c["x"]), e, c["ep"], c["np_"], c["jt"],
                                  compute_dtype=jnp.float32)
    tx, te = _port_call(c, fused_gn_block_nk_reference, torch.float32,
                        compute_dtype=torch.float32)
    np.testing.assert_allclose(_f32(tx), _f32(jx), rtol=1e-5, atol=1e-5)
    if not c["last"]:
        np.testing.assert_allclose(_f32(te), _f32(je), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", VARIANTS)
def test_wrapper_on_cpu_matches_pallas_interpret_bf16(variant):
    c = _case(variant, seed=1)
    jx, je = j_fused(jnp.asarray(c["x"], jnp.bfloat16), jnp.asarray(c["e"], jnp.bfloat16),
                     c["ep"], c["np_"], c["jt"], interpret=True, edge_encoder_params=c["enc"],
                     last_block=c["last"])
    before = fused_gn_block_nk.launches
    tx, te = _port_call(c, fused_gn_block_nk, torch.bfloat16)
    assert fused_gn_block_nk.launches == before  # CPU tensors: plain version, no launch
    assert tx.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(tx), _f32(jx), rtol=0.05, atol=0.05)
    if not c["last"]:
        # padded slots of a folded block hold enc(raw): compare valid slots only
        rows = c["mask"].numpy() if c["enc"] is not None else slice(None)
        np.testing.assert_allclose(_f32(te)[rows], _f32(je)[rows], rtol=0.05, atol=0.05)
    else:
        assert te.shape == (c["tt"].total_rows, B, H)  # dead edge stream passed through


def test_wrapper_checks_inputs():
    c = _case("middle")
    with pytest.raises(ValueError, match="bf16"):
        _port_call(c, fused_gn_block_nk, torch.float32)
    c["e"] = c["e"][:-128]
    with pytest.raises(ValueError, match="NK layout"):
        _port_call(c, fused_gn_block_nk, torch.bfloat16)


# ---- gradients ------------------------------------------------------------

def _cotangents(c, seed):
    """Random cotangents of x_out and e_out, padded slots included."""
    rng = np.random.default_rng(seed)
    n, rows = c["tt"].num_nodes, c["tt"].total_rows
    return (rng.normal(size=(n, B, H)).astype(np.float32),
            rng.normal(size=(rows, B, H)).astype(np.float32))


def _flax_grads(mlp):
    """A port MLP's parameter gradients as a flax tree ([in, out] kernels)."""
    g = {f"Dense_{i}": {"kernel": d.weight.grad.float().numpy().T,
                        "bias": d.bias.grad.float().numpy()} for i, d in enumerate(mlp.denses)}
    if mlp.norm is not None:
        g["RMSNorm_0"] = {"scale": mlp.norm.scale.grad.float().numpy()}
    return g


def _port_grads(c, fn, dtype, cot, **kw):
    """(value, {name: gradient}) of Σ x_out·gx + Σ e_out·ge through ``fn``
    (e_out left out on the last block), with flax-layout weight gradients."""
    mlps = {"ep": port_mlp(c["ep"], 3 * H, H, H), "np_": port_mlp(c["np_"], 2 * H, H, H)}
    if c["enc"] is not None:
        mlps["enc"] = port_mlp(c["enc"], FE, H, H)
    x = torch.as_tensor(c["x"]).to(dtype).requires_grad_(True)
    e = torch.as_tensor(c["e"]).to(dtype).requires_grad_(c["enc"] is None)
    xo, eo = fn(x, e, c["senders"], c["mask"], mlps["ep"], mlps["np_"], c["tt"],
                encoder_params=mlps.get("enc"), last_block=c["last"], **kw)
    value = (xo.float() * torch.as_tensor(cot[0])).sum()
    if not c["last"]:
        value = value + (eo.float() * torch.as_tensor(cot[1])).sum()
    value.backward()
    value = float(value.detach())
    grads = {"x": x.grad.float().numpy(), **{k: _flax_grads(m) for k, m in mlps.items()}}
    if c["enc"] is None:
        grads["e"] = e.grad.float().numpy()
    return value, grads


def _jax_grad_args(c):
    names = ["x", "ep", "np_"] + (["enc"] if c["enc"] is not None else ["e"])
    vals = {"x": jnp.asarray(c["x"]), "e": jnp.asarray(c["e"]), "ep": c["ep"], "np_": c["np_"],
            "enc": c["enc"]}
    return names, [vals[k] for k in names]


def _leaves(grads, names):
    return [np.asarray(a, np.float32) for name in names for a in jax.tree.leaves(grads[name])]


def _assert_grads(port, jax_grads, names, rel, slack=None):
    """Every gradient leaf within ``rel`` of the JAX one's max magnitude,
    plus that leaf's ``slack`` (an absolute allowance) where given."""
    want = _leaves(dict(zip(names, jax_grads)), names)
    slack = slack or [0.0] * len(want)
    for a, b, extra in zip(_leaves(port, names), want, slack):
        scale = max(np.abs(b).max(), 1e-3)
        np.testing.assert_allclose(a, b, atol=rel * scale + extra, rtol=0)


@pytest.mark.parametrize("variant", VARIANTS)
def test_reference_grads_match_blocked_reference_nk_fp32(variant):
    c = _case(variant, seed=2)
    cot = _cotangents(c, seed=3)
    names, args = _jax_grad_args(c)

    def loss(*a):
        kw = dict(zip(names, a))
        e = kw.get("e")
        if c["enc"] is not None:  # the folded block: encoder first, as an XLA MLP
            e = FlaxMLP(hidden_size=H, out_size=H).apply({"params": kw["enc"]},
                                                         jnp.asarray(c["e"]))
        xo, eo = blocked_reference_nk(kw["x"], e, kw["ep"], kw["np_"], c["jt"],
                                      compute_dtype=jnp.float32)
        v = jnp.sum(xo * cot[0])
        return v if c["last"] else v + jnp.sum(eo * cot[1])

    jv, jg = jax.value_and_grad(loss, argnums=tuple(range(len(names))))(*args)
    tv, tg = _port_grads(c, fused_gn_block_nk_reference, torch.float32, cot,
                         compute_dtype=torch.float32)
    np.testing.assert_allclose(tv, float(jv), rtol=1e-5)
    _assert_grads(tg, jg, names, 1e-4)


@pytest.mark.parametrize("variant", VARIANTS)
def test_wrapper_grads_on_cpu_match_pallas_interpret_bf16(variant):
    c = _case(variant, seed=4)
    cot = _cotangents(c, seed=5)
    names, args = _jax_grad_args(c)

    def loss(*a):
        kw = dict(zip(names, a))
        xo, eo = j_fused(kw["x"].astype(jnp.bfloat16),
                         kw.get("e", jnp.asarray(c["e"])).astype(jnp.bfloat16),
                         kw["ep"], kw["np_"], c["jt"], interpret=True,
                         edge_encoder_params=kw.get("enc"), last_block=c["last"])
        v = jnp.sum(xo.astype(jnp.float32) * cot[0])
        return v if c["last"] else v + jnp.sum(eo.astype(jnp.float32) * cot[1])

    jv, jg = jax.value_and_grad(loss, argnums=tuple(range(len(names))))(*args)
    before = (fused_gn_block_nk.launches, fused_gn_block_nk.backward_launches)
    tv, tg = _port_grads(c, fused_gn_block_nk, torch.bfloat16, cot)
    assert (fused_gn_block_nk.launches, fused_gn_block_nk.backward_launches) == before
    np.testing.assert_allclose(tv, float(jv), rtol=0.02)
    # Gradients: the JAX suite's bound (|a-b| <= 0.04·max|b|,
    # tests/test_fused_gnblock_nk.py:148-156) holds between two kernels that
    # round alike; the plain version rounds where torch's bf16 autograd does.
    # With random cotangents a bf16 backward carries large errors of its own
    # (the Pallas kernel's dx is off its fp32 value by up to ~0.27·max here),
    # so each leaf also gets the Pallas kernel's own max error against the
    # fp32 gradient (the fp32 plain version, which matches the JAX fp32
    # reference to 1e-4 above).
    _, fg = _port_grads(c, fused_gn_block_nk_reference, torch.float32, cot,
                        compute_dtype=torch.float32)
    own = [np.abs(b - f).max() for b, f in zip(_leaves(dict(zip(names, jg)), names),
                                                _leaves(fg, names))]
    _assert_grads(tg, jg, names, 0.04, slack=own)


def fake_launches(monkeypatch):
    """Stand the plain version in for the two kernel launches, so that the
    autograd.Function around them (argument order, the aggregate the
    forward keeps for the backward, the gradients it hands back, the last
    block's dead edge stream, the launch counts) runs on the CPU. The
    stand-ins take and give what the ctypes launches do."""
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops

    def fwd(x, edge_attr, senders, edge_mask, nk, mlps, last_block, keep_agg=False):
        with torch.no_grad():
            xo, eo, agg = _reference_parts(x, edge_attr, senders, edge_mask, mlps, nk, x.dtype)
        nk_ops.fused_gn_block_nk.launches += 1
        return xo, None if last_block else eo, agg if keep_agg else None

    def bwd(x, edge_attr, agg, g_xout, g_eout, senders, edge_mask, nk, mlps):
        assert agg is not None and agg.shape == x.shape  # the forward kept it
        nk_ops.fused_gn_block_nk.backward_launches += 1
        return fused_gn_block_nk_backward_reference(x, edge_attr, agg, g_xout, g_eout, senders,
                                                    edge_mask, nk, mlps)

    monkeypatch.setattr(nk_ops, "_launch_fwd", fwd)
    monkeypatch.setattr(nk_ops, "_launch_bwd", bwd)


@pytest.mark.parametrize("variant", VARIANTS)
def test_autograd_function_routes_the_backward_kernel(monkeypatch, variant):
    """The wrapper's CUDA branch with stand-in launches gives exactly the
    plain version's gradients, one forward and one backward launch."""
    from graph_physics_tpu_torch.ops import fused_gnblock_nk as nk_ops

    fake_launches(monkeypatch)
    c = _case(variant, seed=6)
    cot = _cotangents(c, seed=7)

    def via_function(x, e, senders, mask, edge, node, nk, encoder_params=None,
                     last_block=False):
        return nk_ops._run_kernels(x, e, senders, mask, nk, (encoder_params, edge, node),
                                   last_block)

    before = (fused_gn_block_nk.launches, fused_gn_block_nk.backward_launches)
    tv, tg = _port_grads(c, via_function, torch.bfloat16, cot)
    assert (fused_gn_block_nk.launches, fused_gn_block_nk.backward_launches) == (
        before[0] + 1, before[1] + 1)
    pv, pg = _port_grads(c, fused_gn_block_nk_reference, torch.bfloat16, cot,
                         compute_dtype=torch.bfloat16)
    assert tv == pv
    names = ["x", "ep", "np_"] + (["enc"] if c["enc"] is not None else ["e"])
    for a, b in zip(_leaves(tg, names), _leaves(pg, names)):
        np.testing.assert_array_equal(a, b)


# ---- the plain version of the backward kernel ------------------------------

#: 256 real nodes in two node blocks (node N-1 owns valid slots), with holes
HOLE_MESH = dict(nx=16, ny=16, n_pad=256, holes=True)

def _backward_reference_grads(c, dtype, cot):
    """fused_gn_block_nk_backward_reference on case ``c`` in ``dtype``, from
    the aggregate of the plain forward in ``dtype``: {name: gradient} as
    :func:`_port_grads` gives them (flax-layout weight gradients)."""
    mlps = {"ep": port_mlp(c["ep"], 3 * H, H, H), "np_": port_mlp(c["np_"], 2 * H, H, H)}
    if c["enc"] is not None:
        mlps["enc"] = port_mlp(c["enc"], FE, H, H)
    order = (mlps.get("enc"), mlps["ep"], mlps["np_"])
    x, e = torch.as_tensor(c["x"]).to(dtype), torch.as_tensor(c["e"]).to(dtype)
    _, _, agg = _reference_parts(x, e, c["senders"], c["mask"], order, c["tt"], dtype)
    g_xout = torch.as_tensor(cot[0]).to(dtype)
    g_eout = None if c["last"] else torch.as_tensor(cot[1]).to(dtype)
    dx, de, flat = fused_gn_block_nk_backward_reference(
        x, e, agg, g_xout, g_eout, c["senders"], c["mask"], c["tt"], order)
    grads = {"x": dx.float().numpy()}
    if de is not None:
        grads["e"] = de.float().numpy()
    for key, m in (("enc", order[0]), ("ep", order[1]), ("np_", order[2])):
        if m is None:
            continue
        n_p = len(m.denses) * 2 + (m.norm is not None)
        part, flat = flat[:n_p], flat[n_p:]
        tree = {f"Dense_{i}": {"kernel": part[2 * i].numpy().T, "bias": part[2 * i + 1].numpy()}
                for i in range(len(m.denses))}
        if m.norm is not None:
            tree["RMSNorm_0"] = {"scale": part[-1].numpy()}
        grads[key] = tree
    return grads


def _kink_free(c, cot):
    """The cotangents with zeros where the fp32 gradient has no one value
    (tests/test_torch_csr_train.py:_away_from_kinks, on the slot layout): at
    every (slot, sample) whose encoder or edge MLP has a relu pre-activation
    within KINK of 0, at its receiver, and at every (node, sample) whose
    node MLP has one. Two fp32 computations that sum in different orders
    may put such a pre-activation on either side of the kink."""
    from tests.test_torch_csr_train import _pre_acts_near_kink

    x, e = torch.as_tensor(c["x"]), torch.as_tensor(c["e"])
    s, m = c["senders"].long(), c["mask"]
    kk, nb = c["tt"].k_slots, c["tt"].node_block
    slots = torch.arange(c["tt"].total_rows)
    r = (slots // (kk * nb)) * nb + slots % nb  # slot g·K·nb + k·nb + r: receiver g·nb + r
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
        near_x |= torch.zeros_like(near_x).index_add_(0, r, near_e.to(near_x.dtype)) > 0
    return (np.where(near_x.numpy()[..., None], 0.0, cot[0]).astype(np.float32),
            np.where(near_e.numpy()[..., None], 0.0, cot[1]).astype(np.float32))


def test_hole_case_masks_slots_between_valid_ones():
    c = _case("middle", **HOLE_MESH)
    tt, mask = c["tt"], c["mask"].numpy().reshape(-1, c["tt"].k_slots, c["tt"].node_block)
    assert tt.num_nodes == 256 and mask[-1, :, -1].any()  # node N-1 is real, owns slots
    assert (~mask[:, 1] & mask[:, 2]).any()  # masked slot k=1 before a valid k=2


@pytest.mark.parametrize("variant", VARIANTS)
def test_backward_reference_fp32_matches_jax_grad_of_blocked_reference(variant):
    c = _case(variant, seed=8, **HOLE_MESH)
    cot = _kink_free(c, _cotangents(c, seed=9))
    names, args = _jax_grad_args(c)

    def loss(*a):
        kw = dict(zip(names, a))
        e = kw.get("e")
        if c["enc"] is not None:  # the folded block: encoder first, as an XLA MLP
            e = FlaxMLP(hidden_size=H, out_size=H).apply({"params": kw["enc"]},
                                                         jnp.asarray(c["e"]))
        xo, eo = blocked_reference_nk(kw["x"], e, kw["ep"], kw["np_"], c["jt"],
                                      compute_dtype=jnp.float32)
        v = jnp.sum(xo * cot[0])
        return v if c["last"] else v + jnp.sum(eo * cot[1])

    jg = jax.grad(loss, argnums=tuple(range(len(names))))(*args)
    _assert_grads(_backward_reference_grads(c, torch.float32, cot), jg, names, 1e-5)


@pytest.mark.parametrize("variant", VARIANTS)
def test_backward_reference_bf16_matches_pallas_interpret(variant):
    c = _case(variant, seed=10, **HOLE_MESH)
    cot = _cotangents(c, seed=11)
    names, args = _jax_grad_args(c)

    def loss(*a):
        kw = dict(zip(names, a))
        xo, eo = j_fused(kw["x"].astype(jnp.bfloat16),
                         kw.get("e", jnp.asarray(c["e"])).astype(jnp.bfloat16),
                         kw["ep"], kw["np_"], c["jt"], interpret=True,
                         edge_encoder_params=kw.get("enc"), last_block=c["last"])
        v = jnp.sum(xo.astype(jnp.float32) * cot[0])
        return v if c["last"] else v + jnp.sum(eo.astype(jnp.float32) * cot[1])

    jg = jax.grad(loss, argnums=tuple(range(len(names))))(*args)
    # the JAX suite's bound between two kernels that round alike
    # (|a - b| <= 0.04·max|b|, tests/test_fused_gnblock_nk.py:148-156): the
    # plain version rounds the node partials where the Pallas kernel does
    _assert_grads(_backward_reference_grads(c, torch.bfloat16, cot), jg, names, 0.04)
