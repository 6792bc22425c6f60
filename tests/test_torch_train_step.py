"""The port's training slice against the JAX package, on the CPU.

  * noise: zero off NORMAL nodes and outside [s:e], std σ (5% over a large
    draw), the cosine curriculum at t=0 (20σ) and t=1 (exactly zero);
  * loss: the masked L2 equals the JAX package's at 1e-6, packed and single;
  * optimizer: clip + AdamW + cosine warmup equals the optax chain at 1e-6
    over 8 steps of fixed gradients that cross the warmup and hit the clip;
  * one train step (noise off) from the same weights: the fp32 plain path
    and the bf16 fused NK path (Pallas in interpret mode in JAX) against
    the JAX step, after 1 and 3 steps: loss, grad norm, normalizer
    statistics and parameters (through JAX's convert_state_dict);
  * make_multi_step: K steps on one batch equal K train steps drawing their
    noise from the generator in turn.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graph_physics_tpu.core.nodetype import NodeType
from graph_physics_tpu.models.processors import EncodeProcessDecode as JaxEPD
from graph_physics_tpu.ops import tiling as jtiling
from graph_physics_tpu.ops.fused_edge_attention_nk import build_nk_tiling as j_build_nk
from graph_physics_tpu.training import loss as jloss
from graph_physics_tpu.training import packed as jpacked
from graph_physics_tpu.training import schedule as jschedule
from graph_physics_tpu.training import step as jstep
from graph_physics_tpu.utils.convert import convert_state_dict
from graph_physics_tpu_torch import entry
from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.ops import tiling as ttiling
from graph_physics_tpu_torch.ops.fused_gnblock_nk import fused_gn_block_nk
from graph_physics_tpu_torch.training import loss as tloss
from graph_physics_tpu_torch.training import noise as tnoise
from graph_physics_tpu_torch.training import packed as tpacked
from graph_physics_tpu_torch.training import schedule as tschedule
from graph_physics_tpu_torch.training import step as tstep
from graph_physics_tpu_torch.utils.convert import load_jax_params
from tests.helpers import tiny_graph
from tests.test_torch_fused_gnblock_nk import _port_host_graph
from tests.test_torch_simulator import KW, PARAM, _jax_sim, _to_np

NORMAL = int(NodeType.NORMAL)
LR = 1e-3


def _packed_graphs(count=4, nk=False):
    """(JAX, port) packed batches of frames 0..count-1 of the 14x10 mesh,
    optionally in the NK slot layout, with each side's NK tiling."""
    frames = [tiny_graph(nx=14, ny=10, frame=f) for f in range(count)]
    jt = tt = None
    ports = [_port_host_graph(f) for f in frames]
    if nk:
        n = frames[0].x.shape[0]
        args = (np.asarray(frames[0].senders), np.asarray(frames[0].receivers), n)
        jt = j_build_nk(*args, edge_mask=np.asarray(frames[0].edge_mask), node_block=128)
        tt = ttiling.build_nk_tiling(*args, edge_mask=np.asarray(frames[0].edge_mask))
        frames = [jtiling.apply_to_graph_nk(f, jt) for f in frames]
        ports = [ttiling.apply_to_graph_nk(p, tt) for p in ports]
    jg = jpacked.pack(jax.tree.map(lambda *xs: np.stack(xs), *frames))
    tg = MeshGraph.from_numpy(tpacked.pack(tpacked.stack(ports)), "cpu")
    return jg, tg, jt, tt


# ---- noise ----------------------------------------------------------------

def _noise_graph(batch=64):
    _, tg, _, _ = _packed_graphs()
    x = torch.zeros((tg.x.shape[0], batch, 4))
    return tg.replace(x=x)


def test_noise_only_on_normal_nodes_and_columns():
    g = _noise_graph()
    gen = torch.Generator().manual_seed(0)
    out = tnoise.add_noise(g, gen, [0], [2], [0.02]).x
    normal = (g.node_type == NORMAL)
    assert not out[~normal].any()
    assert not out[..., 2:].any()
    assert out[normal][..., :2].abs().min() > 0
    assert torch.equal(g.x, torch.zeros_like(g.x))  # the input is not modified


def test_noise_std_and_curriculum():
    g = _noise_graph(batch=512)
    normal = g.node_type == NORMAL
    sigma = 0.02
    draw = tnoise.add_noise(g, torch.Generator().manual_seed(1), 0, 2, sigma).x[normal][..., :2]
    assert abs(draw.std().item() / sigma - 1) < 0.05
    t0 = tnoise.add_noise(g, torch.Generator().manual_seed(2), 0, 2, sigma, t=0.0).x
    assert abs(t0[normal][..., :2].std().item() / (20 * sigma) - 1) < 0.05
    t1 = tnoise.add_noise(g, torch.Generator().manual_seed(3), 0, 2, sigma, t=1.0).x
    assert torch.equal(t1, g.x)


# ---- loss -----------------------------------------------------------------

@pytest.mark.parametrize("packed", [True, False])
def test_l2_loss_matches_jax(packed):
    jg, tg, _, _ = _packed_graphs()
    rng = np.random.default_rng(0)
    if not packed:  # one frame: x [N, F], shared metadata
        jg = jax.tree.map(lambda a: a, tiny_graph(nx=14, ny=10))
        tg = MeshGraph.from_numpy(_port_host_graph(jg), "cpu")
    shape = tg.x.shape[:-1] + (2,)
    out = rng.normal(size=shape).astype(np.float32)
    tgt = rng.normal(size=shape).astype(np.float32)
    want = jloss.l2_loss(jloss.LossInputs(graph=jax.tree.map(jnp.asarray, jg),
                                          network_output=jnp.asarray(out),
                                          target=jnp.asarray(tgt)))
    got = tloss.l2_loss(tg, torch.as_tensor(out), torch.as_tensor(tgt))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# ---- schedule and optimizer -----------------------------------------------

def test_schedule_matches_jax():
    j = jschedule.cosine_warmup_schedule(1e-3, 5, 40)
    t = tschedule.cosine_warmup_schedule(1e-3, 5, 40)
    # JAX evaluates in float32, the port in float64: near the end of the
    # cosine 1 + cos(πe/T) cancels, so allow float32's error on cos there
    # (1e-6 of the base rate) beside the relative bound
    for s in range(45):
        np.testing.assert_allclose(t(s), float(j(s)), rtol=1e-5, atol=1e-9)


def test_optimizer_matches_optax():
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 2)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    # global gradient norms of about these sizes: the clip at 1.0 acts on half
    norms = [0.1, 3.0, 0.3, 10.0, 0.5, 2.0, 0.05, 5.0]
    grads = []
    for target in norms:
        g = {k: rng.normal(size=s) for k, s in shapes.items()}
        total = np.sqrt(sum(np.sum(v ** 2) for v in g.values()))
        grads.append({k: (v * target / total).astype(np.float32) for k, v in g.items()})
    opt = jschedule.make_optimizer(1e-2, warmup=3, num_steps=20)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = opt.init(jp)
    params = {k: torch.nn.Parameter(torch.as_tensor(v.copy())) for k, v in p0.items()}
    topt = tschedule.make_optimizer(1e-2, warmup=3, num_steps=20).init(params.values())
    clipped = 0
    for g in grads:
        upd, jst = opt.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            p.grad = torch.as_tensor(g[k].copy())
        norm = topt.step()
        want_norm = float(optax.global_norm(g))
        np.testing.assert_allclose(norm.item(), want_norm, rtol=1e-6)
        clipped += want_norm > 1.0
        for k in params:
            np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    assert 0 < clipped < len(grads)
    with pytest.raises(NotImplementedError):
        tschedule.make_optimizer(1e-3, 1, 10, accumulate_grad_batches=2)


# ---- one train step against JAX -------------------------------------------

def run_steps(jsim, jgraph, tsim, tgraph, param, n_steps, jit_init=False):
    """JAX and port metrics and state after each of ``n_steps`` steps on one
    packed batch, noise off, from the JAX model's initial weights loaded
    into ``tsim`` (lr 1e-3 from step 0); ``param`` is the configuration
    convert_state_dict reads the port's state with. ``jit_init`` compiles
    JAX's parameter initialisation instead of running it op by op."""
    opt = jschedule.make_optimizer(LR, warmup=1, num_steps=10)
    g = jax.tree.map(jnp.asarray, jgraph)
    init = jstep.init_train_state
    if jit_init:
        init = jax.jit(init, static_argnums=(0, 1))
    jstate = init(jsim, opt, jax.random.PRNGKey(0), g)
    jtrain = jstep.make_train_step(jsim, opt, jloss.LossType.L2LOSS, None, donate=False)
    load_jax_params(tsim, _to_np(jstate.params), _to_np(jstate.sim_state))
    tstate = tstep.init_train_state(tsim, tschedule.make_optimizer(LR, warmup=1, num_steps=10))
    ttrain = tstep.make_train_step(tsim)
    out = []
    for _ in range(n_steps):
        jstate, jm = jtrain(jstate, g, jax.random.PRNGKey(1))
        tm = ttrain(tstate, tgraph, torch.Generator().manual_seed(1))
        # copies: the port updates its parameters and statistics in place
        params, sim_state = convert_state_dict(
            {k: v.detach().float().numpy().copy() for k, v in tsim.state_dict().items()}, param)
        out.append((jm, tm, jstate, params, sim_state))
    return out


def _steps(nk, n_steps):
    jg, tg, jt, tt = _packed_graphs(nk=nk)
    jdtype, tdtype = (jnp.bfloat16, torch.bfloat16) if nk else (jnp.float32, torch.float32)
    jsim = _jax_sim(JaxEPD(**dict(KW, dtype=jdtype, edge_tiling_nk=jt)))
    tsim = entry.make_simulator(32, 2, tdtype, tt, seed=9)
    return run_steps(jsim, jg, tsim, tg, PARAM, n_steps)


def check_fp32_steps(runs, noisy_share=0.0, far_share=0.0):
    """The fp32 plain path's bounds against the JAX step. A gradient within
    fp32 rounding of 0 takes its sign from the order of the sums, and Adam
    scales it to a step of up to lr: ``noisy_share`` of the parameter
    values may lie up to 2·lr a step apart for that reason, and
    ``far_share`` of them more than lr/2."""
    for i, (jm, tm, jstate, params, sim_state) in enumerate(runs):
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(tm["loss_term_0"].item(), float(jm["loss_term_0"]), rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
        # fp32 sums in another order; Adam moves each parameter by about
        # lr·sign(g) = 1e-3 a step, so 1e-5 is 1% of one step
        compare_state(jstate, params, sim_state, param_atol=1e-5, noisy_share=noisy_share,
                      noisy_atol=2 * LR * (i + 1), far_share=far_share)


def check_bf16_steps(runs):
    """The bf16 fused path's bounds against the JAX fused step."""
    for i, (jm, tm, jstate, params, sim_state) in enumerate(runs):
        # the JAX suite's value bound; the grad norm of two bf16 backwards
        # (2e-4 apart on step 1, 2.3% by step 3 as the parameters drift)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=0.02)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=0.1)
        # bf16 gradients round differently in the two, so small gradients
        # may take the other sign: a parameter then lands up to 2·lr per
        # step away (Adam's first steps move by about lr·sign(g)). That is
        # rare: about 1-1.6% of the values after 1-3 steps, so 3% is bound.
        compare_state(jstate, params, sim_state, param_atol=2 * LR * (i + 1) + 1e-6,
                      far_share=0.03)


def compare_state(jstate, params, sim_state, param_atol, far_share=0.0, noisy_share=0.0,
                  noisy_atol=None):
    """Normalizer statistics, then every parameter within ``param_atol`` (all
    but ``noisy_share`` of the values, the rest within ``noisy_atol``), and
    at most ``far_share`` of all parameter values more than lr/2 apart."""
    for norm in ("output_norm", "node_norm", "edge_norm"):
        js, ts = getattr(jstate.sim_state, norm), getattr(sim_state, norm)
        assert (js is None) == (ts is None), norm
        if js is None:  # no edge features
            continue
        for f in ("acc_sum", "acc_sum_sq", "acc_count", "num_accumulations"):
            want = np.asarray(getattr(js, f))
            # fp32 sums in another order; sums of signed features (Δpos)
            # cancel to near zero, so the bound is relative to the largest
            np.testing.assert_allclose(np.asarray(getattr(ts, f)), want, rtol=1e-5,
                                       atol=1e-6 * np.abs(want).max(), err_msg=f"{norm}.{f}")
    jp = jstate.params.get("params", jstate.params)
    flat_t = jax.tree_util.tree_flatten_with_path(params.get("params", params))[0]
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    assert len(flat_t) == len(flat_j)
    far = noisy = total = 0
    for path, v in flat_t:
        want = np.asarray(flat_j[path], np.float32)
        np.testing.assert_allclose(np.asarray(v), want, rtol=0,
                                   atol=noisy_atol if noisy_share else param_atol,
                                   err_msg=jax.tree_util.keystr(path))
        diff = np.abs(np.asarray(v) - want)
        noisy += int(np.sum(diff > param_atol))
        far += int(np.sum(diff > LR / 2))
        total += want.size
    assert noisy <= noisy_share * total, (noisy, total)
    assert far <= far_share * total, (far, total)


def test_train_step_fp32_plain_path_matches_jax():
    check_fp32_steps(_steps(nk=False, n_steps=3))


def test_train_step_bf16_nk_path_matches_jax_fused():
    before = (fused_gn_block_nk.launches, fused_gn_block_nk.backward_launches)
    runs = _steps(nk=True, n_steps=3)
    assert (fused_gn_block_nk.launches, fused_gn_block_nk.backward_launches) == before
    check_bf16_steps(runs)


def test_multi_step_is_k_train_steps_drawing_noise_in_turn():
    _, tg, _, _ = _packed_graphs()
    runs = []
    for multi in (True, False):
        sim = entry.make_simulator(32, 2, torch.float32, None, seed=5)
        state = tstep.init_train_state(sim, tschedule.make_optimizer(LR, warmup=2, num_steps=10))
        step = tstep.make_train_step(sim, noise_cfg=entry.NOISE, num_steps=10)
        gen = torch.Generator().manual_seed(4)
        if multi:
            m = tstep.make_multi_step(step, unroll=3)(state, tg, gen)
        else:
            ms = [step(state, tg, gen) for _ in range(3)]
            m = {k: torch.stack([x[k] for x in ms]) for k in ms[0]}
        runs.append((m, state.step, {k: v.clone() for k, v in sim.state_dict().items()}))
    (m1, s1, p1), (m2, s2, p2) = runs
    assert s1 == s2 == 3 and m1["loss"].shape == (3,)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
