"""The port's Transolver++ slice (Simulator, train step, rollout) against the JAX package, on the CPU.

A 2-block Transolver (hidden 16, 2 heads, 8 slices) in fp32, on stacked
[B, N, F] batches of B=3 different frames of the 14x10 mesh:

  * the eval forward of ``Simulator`` + ``TransolverProcessor`` against
    JAX's ``Simulator.forward`` (``apply_model`` vmaps the stacked layout,
    simulator.py:219-243) at 1e-4, with the normalizer statistics the
    port accumulates over all valid B·N rows equal to JAX's;
  * with the same injected slice noise (``gumbel_softmax`` replaced in
    both packages inside the test; tests/test_torch_transolver.py), the
    step's loss and every gradient against ``jax.value_and_grad`` of
    JAX's loss, then two train steps against ``make_train_step``: loss,
    grad norm, normalizer statistics and parameters after each AdamW
    update (tests/test_torch_train_step.py's fp32 bounds);
  * a 6-step rollout on single [N, F] frames against JAX's
    ``make_rollout_fn`` at 1e-4 (tests/test_torch_rollout.py's bound);
  * ``entry.transolver_train_setup`` on the CPU: the fused draw takes the
    plain version there (no launch) and gives the same steps as the
    model with ``use_plain_gumbel``; eval draws no noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from graph_physics_tpu.models.processors import TransolverProcessor as JTP
from graph_physics_tpu.models.simulator import Simulator as JSim
from graph_physics_tpu.training import loss as jloss
from graph_physics_tpu.training import rollout as jrollout
from graph_physics_tpu.utils.convert import convert_state_dict
from graph_physics_tpu_torch import entry
from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.models.transolver import use_plain_gumbel
from graph_physics_tpu_torch.ops import gumbel as gumbel_ops
from graph_physics_tpu_torch.training import loss as tloss
from graph_physics_tpu_torch.training import packed as tpacked
from graph_physics_tpu_torch.training import rollout as trollout
from graph_physics_tpu_torch.training import step as tstep
from graph_physics_tpu_torch.utils.convert import load_jax_params
from tests.helpers import tiny_graph
from tests.test_torch_fused_gnblock_nk import _port_host_graph
from tests.test_torch_rollout import _jax_stack, _port_frames, _window
from tests.test_torch_train_step import check_fp32_steps, run_steps
from tests.test_torch_transolver import (  # noqa: F401  (injected_noise is a fixture)
    G,
    H,
    LAYERS,
    PARAM,
    C,
    injected_noise,
    randomized,
)

B = 3
TOL = dict(rtol=1e-4, atol=1e-4)


def _jax_sim():
    return JSim(node_input_size=11, edge_input_size=0, output_size=2, feature_index_start=0,
                feature_index_end=2, output_index_start=0, output_index_end=2,
                node_type_index=2,
                model=JTP(message_passing_num=LAYERS, node_input_size=11, output_size=2,
                          hidden_size=C, num_heads=H, slice_num=G))


def _port_sim(params, state):
    sim = entry.make_transolver_simulator(hidden=C, mp_steps=LAYERS, heads=H, slices=G,
                                          dtype=torch.float32, fused_gumbel=False, seed=3)
    load_jax_params(sim, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    return sim


def _stacked(count=B):
    """(JAX, port) stacked [B, N, F] batches of frames 0..count-1."""
    frames = [tiny_graph(nx=14, ny=10, frame=f) for f in range(count)]
    jg = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *frames)
    tg = MeshGraph.from_numpy(tpacked.stack([_port_host_graph(f) for f in frames]), "cpu")
    return jg, tg


def _jax_setup(jg, seed=0):
    jsim = _jax_sim()
    params = randomized(jax.jit(jsim.init_params)(jax.random.PRNGKey(seed), jg), seed=seed + 1)
    return jsim, params


def test_stacked_eval_forward_matches_jax():
    jg, tg = _stacked()
    jsim, params = _jax_setup(jg)
    state = jax.jit(lambda g: jsim.prepare(jsim.init_state(), g, is_training=True)[3])(jg)
    jout = jax.jit(lambda p, s, g: jsim.forward(p, s, g, is_training=False))(params, state, jg)
    tsim = _port_sim(params, state)
    tout = tsim.forward(tg, is_training=False)
    assert tout.outputs.shape == (B, tg.x.shape[1], 2)
    for name in ("net_out", "target_norm", "outputs"):
        np.testing.assert_allclose(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
                                   **TOL, err_msg=name)
    # the port's own accumulation over the stacked batch: all valid B·N rows
    fresh = _port_sim(params, jsim.init_state())
    fresh.prepare(tg, is_training=True)
    for norm, js in ((fresh._output_normalizer, state.output_norm),
                     (fresh._node_normalizer, state.node_norm)):
        np.testing.assert_allclose(norm._acc_sum.numpy(), np.asarray(js.acc_sum), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(norm._acc_sum_squared.numpy(), np.asarray(js.acc_sum_sq),
                                   rtol=1e-5, atol=1e-5)
        assert float(norm._acc_count) == float(js.acc_count) == float(tg.node_mask.sum())


def test_noisy_loss_and_gradients_match_jax(injected_noise):
    jg, tg = _stacked()
    jsim, params = _jax_setup(jg, seed=4)
    injected_noise(LAYERS, tg.x.shape[1], seed=5)

    def jax_loss(p):
        g_in, target, _, _ = jsim.prepare(jsim.init_state(), jg, is_training=True)
        out = jsim.apply_model(p, g_in, rngs={"gumbel": jax.random.PRNGKey(6)})
        return jloss.l2_loss(jloss.LossInputs(graph=jg, network_output=out, target=target))

    want_loss, want = jax.jit(jax.value_and_grad(jax_loss))(params)
    tsim = _port_sim(params, jsim.init_state())
    out = tsim.forward(tg, is_training=True, gumbel=torch.Generator().manual_seed(0))
    loss = tloss.l2_loss(tg, out.net_out, out.target_norm)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for k, p in tsim.named_parameters()}
    flat = {k: v.numpy() for k, v in tsim.state_dict().items()}
    flat.update(grads)
    got, _ = convert_state_dict(flat, PARAM)
    paths = jax.tree_util.tree_flatten_with_path(got)[0]
    want_flat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(paths) == len(want_flat)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want_flat.values())
    for path, v in paths:
        np.testing.assert_allclose(np.asarray(v), np.asarray(want_flat[path]), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=jax.tree_util.keystr(path))


def test_noisy_train_steps_match_jax(injected_noise):
    jg, tg = _stacked()
    injected_noise(LAYERS, tg.x.shape[1], seed=7)
    jsim = _jax_sim()
    tsim = entry.make_transolver_simulator(hidden=C, mp_steps=LAYERS, heads=H, slices=G,
                                           dtype=torch.float32, fused_gumbel=False, seed=3)
    check_fp32_steps(run_steps(jsim, jg, tsim, tg, PARAM, n_steps=2, jit_init=True))


def test_rollout_on_single_frames_matches_jax():
    frames = _window(0, 6)
    jg = jax.tree.map(jnp.asarray, frames[0])
    jsim, params = _jax_setup(jg, seed=8)
    state = jax.jit(lambda g: jsim.prepare(jsim.init_state(), g, is_training=True)[3])(jg)
    res_j = jrollout.make_rollout_fn(jsim)(params, state, _jax_stack(frames))
    res_t = trollout.make_rollout_fn(_port_sim(params, state))(_port_frames([frames]))
    np.testing.assert_allclose(res_t.predictions.numpy(), np.asarray(res_j.predictions), **TOL)
    for name in ("rmse_all_rollout", "rmse_1step", "val_loss"):
        np.testing.assert_allclose(getattr(res_t, name).numpy(),
                                   np.asarray(getattr(res_j, name)), **TOL, err_msg=name)


def _losses(train, n=2, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [train.train_step(train.state, train.graph, gen)["loss"].item() for _ in range(n)]


def test_entry_transolver_train_setup_on_cpu():
    kw = dict(nx=14, ny=10, batch=2, mp_steps=2)
    fused = entry.transolver_train_setup("cpu", **kw)
    assert fused.graph.x.shape[0] == 2 and fused.graph.node_type.shape == fused.graph.x.shape[:2]
    assert tstep.model_uses_gumbel(fused.simulator.model)
    plain = entry.transolver_train_setup("cpu", **kw)
    use_plain_gumbel(plain.simulator)
    rand = entry.transolver_train_setup("cpu", fused_gumbel=False, **kw)
    before = gumbel_ops.gumbel_perturb.launches
    lf, lp, lr = _losses(fused), _losses(plain), _losses(rand)
    assert gumbel_ops.gumbel_perturb.launches == before  # the CPU takes the plain version
    assert lf == lp  # the same Philox bits, through the wrapper or its plain version
    assert lf != lr and all(np.isfinite(lf + lr))
    for p in fused.simulator.parameters():
        assert torch.isfinite(p).all()
    # eval draws no noise
    base = entry.transolver_setup("cpu", nx=14, ny=10, batch=2, mp_steps=2)
    a = base.simulator.forward(base.graph).outputs
    assert torch.equal(a, base.simulator.forward(base.graph).outputs)
