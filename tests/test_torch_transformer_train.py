"""The port's graph-transformer training slice against the JAX package, on the CPU.

  * the NK attention's plain backward (plain autograd of its plain
    version, ``edge_attention_backward_reference``) on the slot arrays
    matches ``jax.grad`` through the Pallas NK attention in interpret mode:
    dq, dk, dv within 0.04·max, the loss at rtol 0.03
    (tests/test_fused_edge_attention_nk.py:102-125);
  * the plain FFN backward ``gated_ffn_backward_reference`` matches
    ``jax.grad`` through the Pallas gated FFN with ``norm2_scale`` in
    interpret mode: dx and all eight parameter gradients within 0.04·max
    (tests/test_fused_ffn.py:100-128), GELU and SiLU;
  * ``sender_slots``, the slot table's transpose the attention backward
    kernel sums over, and its reuse for the same slot arrays;
  * each ``torch.autograd.Function``, with its plain backward standing in
    for the kernel, matches plain autograd of its forward's plain version
    at the same bound: the gradients come back in the right order, for
    every input and parameter;
  * the transformer train step (2 blocks, hidden 64, 4 heads, B=2 on the
    14x10 mesh, noise off) against JAX's ``make_train_step``: the fp32
    plain path over 3 steps at 1e-5 (loss), 1e-4 (grad norm), 1e-5
    (parameters: all but 1e-3 of the values, whose gradients are 0 up to
    rounding, at Adam's step bound), and the bf16 NK path against the JAX fused path
    (Pallas in interpret mode) over 3 steps at the bounds of the ``epd``
    slice (tests/test_torch_train_step.py);
  * ``entry.transformer_train_setup`` takes two steps on the CPU.
The CUDA kernels themselves are tested on a card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.models.processors import EncodeTransformDecode as JETD
from graph_physics_tpu.ops import tiling as jtiling
from graph_physics_tpu.ops.fused_edge_attention_nk import build_nk_tiling as j_build_nk
from graph_physics_tpu.ops.fused_edge_attention_nk import fused_edge_attention_nk as j_fused_attn
from graph_physics_tpu.ops.fused_ffn import fused_gated_ffn as j_fused_ffn
from graph_physics_tpu.training import packed as jpacked
from graph_physics_tpu_torch import entry
from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.ops import fused_edge_attention_nk as ea_ops
from graph_physics_tpu_torch.ops import fused_ffn as ffn_ops
from graph_physics_tpu_torch.ops import tiling as ttiling
from graph_physics_tpu_torch.ops.fused_edge_attention_csr import edge_attention_backward_reference
from graph_physics_tpu_torch.training import packed as tpacked
from graph_physics_tpu_torch.utils.gradcheck import grads_of
from tests.helpers import tiny_graph
from tests.test_torch_edge_attention import _nk_case, _slots
from tests.test_torch_fused_ffn import _flax_block, _norm2, _x
from tests.test_torch_fused_gnblock_nk import _port_host_graph
from tests.test_torch_train_step import _packed_graphs, check_bf16_steps, check_fp32_steps, run_steps
from tests.test_torch_transformer import HEADS, PARAM, H, _jax_sim

#: the JAX suite's gradient bound, |a - b| <= 0.04 · max|b|
GRAD_REL = 0.04


def _close_to_max(got, want, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(np.abs(want).max(), 1e-3)
    np.testing.assert_allclose(got / scale, want / scale, atol=GRAD_REL, err_msg=name)


def _bf16(a):
    return torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16)


# ---- the two plain backwards against the Pallas backwards --------------------

def test_attention_backward_reference_matches_pallas_interpret():
    g, jt, tt, tg, q, k, v = _nk_case(seed=5)
    cot = np.random.default_rng(6).normal(size=q.shape).astype(np.float32)

    def loss(q, k, v):
        return jnp.sum(j_fused_attn(q, k, v, jt, interpret=True).astype(jnp.float32) * cot)

    want_loss, want = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    args = (*(_bf16(a) for a in (q, k, v)), *_slots(tg), tt)
    out = ea_ops.fused_edge_attention_nk_reference(*args)
    np.testing.assert_allclose((out.float() * torch.as_tensor(cot)).sum().item(),
                               float(want_loss), rtol=0.03)
    got = edge_attention_backward_reference(*args, g_out=_bf16(cot))
    for a, c, name in zip(got, want, ("dq", "dk", "dv")):
        assert a.dtype == torch.bfloat16 and a.shape == q.shape
        _close_to_max(a.float().numpy(), c, name)


@pytest.mark.parametrize("use_silu", [False, True])
def test_ffn_backward_reference_matches_pallas_interpret(use_silu):
    _, params, block = _flax_block(use_silu, seed=10, dtype=jnp.bfloat16)
    scale, norm2 = _norm2(seed=11)
    x = _x(seed=12)
    cot = np.random.default_rng(13).normal(size=x.shape).astype(np.float32)

    def loss(x, params, scale):
        y = j_fused_ffn(x, params, activation="silu" if use_silu else "gelu", interpret=True,
                        norm2_scale=scale)
        return jnp.sum(y.astype(jnp.float32) * cot)

    gx, gp, gs = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x, jnp.bfloat16), params,
                                                   jnp.asarray(scale))
    mlp = gp["GatedMLP_0"]
    want = [gs, gp["RMSNorm_0"]["scale"], np.asarray(mlp["Dense_0"]["kernel"]).T,
            mlp["Dense_0"]["bias"], np.asarray(mlp["Dense_1"]["kernel"]).T,
            mlp["Dense_1"]["bias"], np.asarray(gp["Dense_0"]["kernel"]).T, gp["Dense_0"]["bias"]]
    dx, grads = ffn_ops.gated_ffn_backward_reference(_bf16(x), block, norm2, _bf16(cot))
    assert dx.dtype == torch.bfloat16
    _close_to_max(dx.float().numpy(), gx, "dx")
    names = ("dscale2", "dscale", "dW1", "db1", "dW2", "db2", "dW3", "db3")
    for a, c, name in zip(grads, want, names):
        assert a.dtype == torch.float32 and a.shape == np.shape(c), name
        _close_to_max(a.numpy(), c, name)


def test_sender_slots_transpose_the_slot_table():
    """The backward kernel sums dk and dv over ``sender_slots``: each
    sender's valid slots in slot order; the layout keeps it for the same
    slot arrays and computes it again for others or after a change."""
    train = entry.transformer_train_setup("cpu", nx=14, ny=10, batch=2, mp_steps=1)
    g, nk = train.graph, train.tiling
    order, offsets = ttiling.cached_sender_slots(g.senders, g.edge_mask, nk)
    for j in range(nk.num_nodes):
        want = torch.nonzero((g.senders == j) & g.edge_mask).flatten().tolist()
        assert order[offsets[j]:offsets[j + 1]].tolist() == want, j
    assert ttiling.cached_sender_slots(g.senders, g.edge_mask, nk)[0] is order
    mask = g.edge_mask.clone()
    assert ttiling.cached_sender_slots(g.senders, mask, nk)[0] is not order
    kept = ttiling.cached_sender_slots(g.senders, mask, nk)[0]
    mask[int(order[0])] = False
    again = ttiling.cached_sender_slots(g.senders, mask, nk)
    assert again[0] is not kept and int(order[0]) not in again[0][:int(again[1][-1])].tolist()


# ---- the autograd.Functions, plain backward standing in for the kernel -------

def _check_function(fn, plain, inputs, cots):
    got, _ = grads_of(fn, inputs, cots)
    want, _ = grads_of(plain, inputs, cots)
    assert len(got) == len(want)
    for i, (a, c) in enumerate(zip(got, want)):
        assert a.shape == c.shape, i
        _close_to_max(a.numpy(), c.numpy(), f"gradient {i}")


def test_attention_function_backward_matches_autograd():
    g, jt, tt, tg, q, k, v = _nk_case(seed=7)
    slots = _slots(tg)
    cot = _bf16(np.random.default_rng(8).normal(size=q.shape))
    _check_function(
        lambda *qkv: (ea_ops.reference_with_backward(*qkv, *slots, tt), []),
        lambda *qkv: (ea_ops.fused_edge_attention_nk_reference(*qkv, *slots, tt), []),
        [_bf16(a) for a in (q, k, v)], [cot])


@pytest.mark.parametrize("use_silu", [False, True])
def test_ffn_function_backward_matches_autograd(use_silu):
    _, _, block = _flax_block(use_silu, seed=14, dtype=jnp.bfloat16)
    _, norm2 = _norm2(seed=15)
    params = ffn_ops._params(block, norm2)
    cot = _bf16(np.random.default_rng(16).normal(size=(256, 2, H)))
    _check_function(
        lambda x: (ffn_ops.reference_with_backward(x, block, norm2), params),
        lambda x: (ffn_ops.gated_ffn_reference(x, block, norm2), params),
        [_bf16(_x(seed=17))], [cot])


# ---- the train step against JAX's ---------------------------------------------

def _tf_steps(nk, n_steps):
    """JAX and port states over ``n_steps`` transformer train steps on B=2
    packed frames of the 14x10 mesh: fp32 on the plain path, or bf16 with
    the JAX model on its fused path (the blocked-CSR layout with both
    tilings, as tests/test_fused_edge_attention_nk.py:128-171 builds it)
    and the port on the NK slot layout."""
    kw = dict(message_passing_num=2, node_input_size=11, output_size=2, hidden_size=H,
              num_heads=HEADS)
    if not nk:
        jg, tg, _, _ = _packed_graphs(count=2)
        jsim = _jax_sim(JETD(dtype=jnp.float32, **kw))
        tsim = entry.make_transformer_simulator(H, 2, HEADS, torch.float32, None, seed=9)
        return run_steps(jsim, jg, tsim, tg, PARAM, n_steps)
    frames = [tiny_graph(nx=14, ny=10, frame=f) for f in range(2)]
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
    jsim = _jax_sim(JETD(edge_tiling=t, edge_tiling_nk=t_nk, dtype=jnp.bfloat16, **kw))
    tsim = entry.make_transformer_simulator(H, 2, HEADS, torch.bfloat16, tt, seed=9)
    return run_steps(jsim, jg, tsim, tg, PARAM, n_steps)


def test_transformer_train_step_fp32_plain_path_matches_jax():
    # the attention has gradients that are 0 up to rounding (a bias added
    # to every key shifts all of a receiver's logits alike, which the
    # softmax cancels): 13 of 134,210 values after step 1 and 41 after
    # step 3 lie more than 1e-5 apart, so 1e-3 of them may
    check_fp32_steps(_tf_steps(nk=False, n_steps=3), noisy_share=1e-3)


def test_transformer_train_step_bf16_nk_path_matches_jax_fused():
    counts = (ea_ops.fused_edge_attention_nk, ffn_ops.fused_gated_ffn)
    before = [(f.launches, f.backward_launches) for f in counts]
    runs = _tf_steps(nk=True, n_steps=3)
    assert [(f.launches, f.backward_launches) for f in counts] == before  # CPU: no launch
    check_bf16_steps(runs)


def test_entry_transformer_train_setup_takes_steps_on_cpu():
    train = entry.transformer_train_setup("cpu", nx=14, ny=10, batch=4, mp_steps=2)
    assert train.graph.x.shape[1] == 4 and len(train.simulator.model.processor_list) == 2
    gen = torch.Generator().manual_seed(0)
    losses = [train.train_step(train.state, train.graph, gen)["loss"].item() for _ in range(2)]
    assert train.state.step == 2 and all(np.isfinite(losses))
    for p in train.simulator.parameters():
        assert torch.isfinite(p).all()
