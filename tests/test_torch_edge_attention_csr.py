"""The port's CSR edge attention against the JAX package, on a graded mesh.

On the 1,536-node graded test mesh (node N-1 is a real node with
in-edges), in the original node order:
  * the plain version, ``ops/edge_attention.edge_attention`` on the CSR
    edge list, matches JAX's ``edge_attention`` on the original edge list
    in fp32 (1e-5);
  * the wrapper on CPU tensors (that plain version in bf16, no launch)
    matches the Pallas kernel ``fused_edge_attention`` in interpret mode at
    rtol 0.03, atol 0.02 (tests/test_fused_edge_attention_nk.py:96-99, the
    bound the NK kernel is held to), and gives exact zeros on receivers
    whose rows are all masked out (node N-1 among them).
The CUDA kernel itself is tested on a card by tests/test_torch_cuda.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.ops.edge_attention import edge_attention as j_edge_attention
from graph_physics_tpu.ops.fused_edge_attention import fused_edge_attention as j_fused
from graph_physics_tpu_torch.ops.edge_attention import edge_attention
from graph_physics_tpu_torch.ops.fused_edge_attention_csr import fused_edge_attention_csr
from tests.test_torch_csr_layout import graded_graph
from tests.test_torch_fused_gnblock_csr import _layouts

B, HEADS, DH = 2, 4, 16


def _qkv(n, seed, dtype):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor((rng.normal(size=(n, B, HEADS, DH))).astype(np.float32)).to(dtype)
            for _ in range(3)]


def test_plain_version_matches_jax_edge_attention_fp32():
    c = _layouts()
    g = graded_graph()
    q, k, v = _qkv(c["tt"].num_nodes, 0, torch.float32)
    got = edge_attention(q, k, v, c["senders"], c["receivers"], c["mask"])
    want = j_edge_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                            jnp.asarray(g.senders), jnp.asarray(g.receivers),
                            jnp.asarray(g.edge_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("empty", [False, True])
def test_wrapper_on_cpu_matches_pallas_interpret_bf16(empty):
    c = _layouts()
    tt, jt = c["tt"], c["jt"]
    n = tt.num_nodes
    q, k, v = _qkv(n, 1 + empty, torch.bfloat16)
    mask, jmask = c["mask"].clone(), jt.perm >= 0
    gone = np.array([0, 5, n // 2, n - 1]) if empty else np.zeros(0, np.int64)
    for r in gone:  # mask out every row of these receivers in both layouts
        mask[tt.row_ptr[r]:tt.row_ptr[r + 1]] = False
        e_ids = tt.perm[tt.row_ptr[r]:tt.row_ptr[r + 1]]
        jmask &= ~np.isin(jt.perm, e_ids)
    jt_run = jt
    if empty:  # JAX takes the edge set from its tiling: sentinel the masked slots
        sidx = np.where(jmask.reshape(jt.sidx.shape), jt.sidx, jt.window_rows)
        ridx = np.where(jmask.reshape(jt.ridx.shape), jt.ridx, jt.node_block)
        jt_run = dataclasses.replace(jt, sidx=sidx.astype(np.int32), ridx=ridx.astype(np.int32))
    want = j_fused(*(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)), jt_run,
                   interpret=True)
    before = fused_edge_attention_csr.launches
    with torch.no_grad():
        got = fused_edge_attention_csr(q, k, v, c["senders"], c["receivers"], mask, tt)
    assert fused_edge_attention_csr.launches == before
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0.03, atol=0.02)
    no_rows = np.diff(tt.row_ptr) == 0
    no_rows[gone] = True
    assert no_rows.any() == empty  # every node of this mesh has in-edges
    assert (got[torch.as_tensor(no_rows)] == 0).all()


def test_wrapper_checks_inputs():
    c = _layouts()
    q, k, v = _qkv(c["tt"].num_nodes, 3, torch.bfloat16)
    with pytest.raises(ValueError, match="bf16"):
        fused_edge_attention_csr(q.float(), k, v, c["senders"], c["receivers"], c["mask"],
                                 c["tt"])
    with pytest.raises(ValueError, match="one entry per row"):
        fused_edge_attention_csr(q, k, v, c["senders"][:-1], c["receivers"], c["mask"],
                                 c["tt"])
