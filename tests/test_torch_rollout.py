"""The port's autoregressive rollout against the JAX package, on the CPU.

A 10-step rollout (single trajectory, [N, F] frames) and a batched rollout
of R same-mesh windows (packed [T, N, R, F] on the port, vmapped
[R, T, N, F] in JAX) in fp32 agree to 1e-4: predictions feed back for
ten steps, so fp32 differences in the model compound once per step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.training import rollout as jrollout
from graph_physics_tpu_torch import entry
from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.ops.fused_gnblock_nk import fused_gn_block_nk
from graph_physics_tpu_torch.training import rollout as trollout
from tests.helpers import tiny_graph
from tests.test_torch_fused_gnblock_nk import _port_host_graph
from tests.test_torch_simulator import KW, _jax_setup, _port_sim

TOL = dict(rtol=1e-4, atol=1e-4)


def _window(start, steps):
    """Frames start..start+steps-1 of the 14x10 synthetic trajectory."""
    return [tiny_graph(nx=14, ny=10, frame=start + t, num_steps=start + steps + 1)
            for t in range(steps)]


def _jax_stack(frames):
    return jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *frames)


def _port_frames(windows):
    """[T, N, F] frames (one window) or packed [T, N, R, F] (several)."""
    x = np.stack([[f.x for f in w] for w in windows], axis=2)  # [T, N, R, F]
    y = np.stack([[f.y for f in w] for w in windows], axis=2)
    host = _port_host_graph(windows[0][0])
    if len(windows) == 1:
        x, y = x[:, :, 0], y[:, :, 0]
    else:  # packed: edge features [E, R, Fe]
        host = host.replace(edge_attr=np.repeat(host.edge_attr[:, None], len(windows), 1))
    g = MeshGraph.from_numpy(host, "cpu")
    return g.replace(x=torch.as_tensor(x), y=torch.as_tensor(y))


def test_bc_mask_matches_jax():
    g = tiny_graph(nx=14, ny=10)
    want = np.asarray(jrollout.bc_mask(g))
    got = trollout.bc_mask(MeshGraph.from_numpy(_port_host_graph(g), "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)


def _compare(res_t, res_j, pick):
    np.testing.assert_allclose(res_t.predictions.numpy(), pick(res_j.predictions), **TOL)
    for name in ("rmse_all_rollout", "rmse_1step", "val_loss", "sq_sum", "count"):
        np.testing.assert_allclose(getattr(res_t, name).numpy(), pick(getattr(res_j, name)),
                                   **TOL, err_msg=name)


def test_rollout_matches_jax_fp32():
    frames = _window(0, 10)
    jsim, _, params, state = _jax_setup(frames[0], KW)
    res_j = jrollout.make_rollout_fn(jsim)(params, state, _jax_stack(frames))
    res_t = trollout.make_rollout_fn(_port_sim(params, state))(_port_frames([frames]))
    _compare(res_t, res_j, np.asarray)
    assert res_t.predictions.shape == (10, frames[0].x.shape[0], 2)


def test_batched_rollout_matches_jax_fp32():
    windows = [_window(s, 6) for s in (0, 2, 3)]
    jsim, _, params, state = _jax_setup(windows[0][0], KW)
    res_j = jrollout.make_batched_rollout_fn(jsim)(
        params, state, _jax_stack([_jax_stack(w) for w in windows]))
    res_t = trollout.make_batched_rollout_fn(_port_sim(params, state))(_port_frames(windows))

    def pick(a):  # JAX [R, T, ...] -> port [T, N, R, F] / [T, R] / [R]
        a = np.asarray(a)
        if a.ndim == 4:
            return np.moveaxis(a, 0, 2)
        return np.moveaxis(a, 0, 1) if a.ndim == 2 else a

    _compare(res_t, res_j, pick)


def test_batched_rollout_nk_bf16_runs_on_cpu():
    setup = entry.cylinder_setup("cpu", nx=14, ny=10, batch=2, num_steps=8)
    frames = entry.rollout_frames(setup, [0, 2], 5)
    assert frames.x.shape == (5, setup.tiling.num_nodes, 2, 4)
    before = fused_gn_block_nk.launches
    res = trollout.make_batched_rollout_fn(setup.simulator)(frames)
    assert fused_gn_block_nk.launches == before
    assert res.rmse_all_rollout.shape == (2,)
    assert torch.isfinite(res.predictions).all() and torch.isfinite(res.rmse_all_rollout).all()
    with pytest.raises(ValueError, match="R, F"):
        trollout.make_batched_rollout_fn(setup.simulator)(frames.replace(x=frames.x[:, :, 0]))
