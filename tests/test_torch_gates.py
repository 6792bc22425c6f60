"""The transformer's kernel gates against the JAX package's, on the CPU.

JAX fuses the gated FFN only at hidden widths dividing its lane width
(graph_physics_tpu/models/layers.py:521, ``LANES_`` = 128) and edge
attention only at head widths dividing it (:305). Its other terms (B·H
a multiple of 128, N of 128) serve the TPU's lane packing; here B = 16
and the layout's 128-row padding meet them, so JAX's gate reduces to the
width terms, which are read from the JAX package's own constants.

  * ``TransformerBlock`` on an NK layout (bf16, packed) reaches the FFN
    kernel's wrapper exactly where JAX's gate fuses, at hidden 24, 32, 64,
    96, 128, 256 and 512, and the attention kernel's wrapper exactly where
    JAX's does, at head widths 8, 16, 24, 32, 48 and 64;
  * at hidden 256 (8 heads) and at head width 24 (hidden 96, 4 heads) the
    block on the layout matches JAX's bf16 block on the plain path within
    the bf16 bound 0.05 (rtol = atol, tests/test_fused_ffn.py:27-30), on
    the valid nodes, from flax's initial weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.models import layers as jlayers
from graph_physics_tpu.ops import fused_gnblock as j_fused_gnblock
from graph_physics_tpu_torch.models import layers as tlayers
from graph_physics_tpu_torch.ops import tiling as ttiling
from graph_physics_tpu_torch.utils.convert import load_attention, load_gated_mlp
from tests.helpers import tiny_graph
from tests.test_torch_fused_gnblock_nk import _port_host_graph

B = 16
BF16_TOL = dict(rtol=0.05, atol=0.05)


def jax_ffn_fuses(hidden, batch, nodes):
    """JAX's FFN gate (layers.py:517-524) with its own lane constant."""
    lanes = jlayers.LANES_
    return lanes % hidden == 0 and (batch * hidden) % lanes == 0 and nodes % 128 == 0


def jax_attention_fuses(hidden, heads, batch):
    """JAX's attention gate's width terms (layers.py:Attention._fused_attn_ok)."""
    lanes = j_fused_gnblock.LANES
    return lanes % (hidden // heads) == 0 and (batch * hidden) % lanes == 0


@pytest.fixture(scope="module")
def layout():
    g = tiny_graph(nx=14, ny=10)
    args = (np.asarray(g.senders), np.asarray(g.receivers), int(g.n_node))
    nk = ttiling.build_nk_tiling(*args, edge_mask=np.asarray(g.edge_mask))
    host = ttiling.apply_to_graph_nk(_port_host_graph(g), nk)
    return g, nk, host


def _recorded_block(monkeypatch, hidden, heads, layout):
    """Run a bf16 block on the layout; which kernel wrappers it reached."""
    g, nk, host = layout
    calls = []
    for name in ("fused_gated_ffn", "fused_edge_attention_nk"):
        fn = getattr(tlayers, name)
        monkeypatch.setattr(tlayers, name,
                            lambda *a, _fn=fn, _name=name, **k: calls.append(_name) or _fn(*a, **k))
    block = tlayers.TransformerBlock(hidden, heads, dtype=torch.bfloat16)
    x = torch.randn((nk.num_nodes, B, hidden), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        block(x.to(torch.bfloat16), torch.as_tensor(host.senders),
              torch.as_tensor(host.receivers), torch.as_tensor(host.edge_mask),
              torch.as_tensor(host.node_mask), tiling=nk)
    return calls, nk.num_nodes


@pytest.mark.parametrize("hidden", [24, 32, 64, 96, 128, 256, 512])
def test_ffn_gate_matches_jax(monkeypatch, layout, hidden):
    heads = 4 if hidden % 4 == 0 and hidden // 4 <= 32 else 8
    calls, nodes = _recorded_block(monkeypatch, hidden, heads, layout)
    assert ("fused_gated_ffn" in calls) == jax_ffn_fuses(hidden, B, nodes)


@pytest.mark.parametrize("head_dim", [8, 16, 24, 32, 48, 64])
def test_attention_gate_matches_jax(monkeypatch, layout, head_dim):
    calls, _ = _recorded_block(monkeypatch, 4 * head_dim, 4, layout)
    assert ("fused_edge_attention_nk" in calls) == jax_attention_fuses(4 * head_dim, 4, B)


@pytest.mark.parametrize("hidden,heads", [(256, 8), (96, 4)])
def test_block_on_the_layout_matches_jax_plain_path(monkeypatch, layout, hidden, heads):
    g, nk, host = layout
    n0 = g.x.shape[0]
    rng = np.random.default_rng(hidden)
    x0 = (0.5 * rng.normal(size=(n0, 2, hidden))).astype(np.float32)
    x0 = np.asarray(jnp.asarray(x0, jnp.bfloat16).astype(jnp.float32))  # bf16 values
    jargs = [jnp.asarray(a) for a in (g.senders, g.receivers, g.edge_mask, g.node_mask)]
    mod = jlayers.TransformerBlock(hidden_size=hidden, num_heads=heads, dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray, mod.init(jax.random.PRNGKey(3), jnp.asarray(x0),
                                               *jargs)["params"])
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x0, jnp.bfloat16), *jargs),
                      np.float32)
    port = tlayers.TransformerBlock(hidden, heads, dtype=torch.bfloat16)
    with torch.no_grad():
        port.norm1.scale.copy_(torch.as_tensor(params["norm1"]["scale"]))
        port.norm2.scale.copy_(torch.as_tensor(params["norm2"]["scale"]))
    load_attention(port.attention, params["attention"], "attention")
    load_gated_mlp(port.gated_mlp, params["gated_mlp"])
    calls = []
    for name in ("fused_gated_ffn", "fused_edge_attention_nk"):
        fn = getattr(tlayers, name)
        monkeypatch.setattr(tlayers, name,
                            lambda *a, _fn=fn, _name=name, **k: calls.append(_name) or _fn(*a, **k))
    x_t = np.zeros((nk.num_nodes, 2, hidden), np.float32)
    x_t[:n0] = x0
    with torch.no_grad():
        got = port(torch.as_tensor(x_t).to(torch.bfloat16), torch.as_tensor(host.senders),
                   torch.as_tensor(host.receivers), torch.as_tensor(host.edge_mask),
                   torch.as_tensor(host.node_mask), tiling=nk).float().numpy()
    assert calls == (["fused_edge_attention_nk"] if hidden // heads == 32 else [])
    n_real = int(g.n_node)
    np.testing.assert_allclose(got[:n_real], want[:n_real], **BF16_TOL)
