"""The PyTorch port's layers against the JAX package, on the CPU.

Same inputs (numpy, from a seed) through the flax module and its port;
fp32 results agree to 1e-5. Also: the port imports no jax, flax or
graph_physics_tpu module.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.models import layers as jlayers
from graph_physics_tpu.models import normalizer as jnorm
from graph_physics_tpu_torch.models import layers as tlayers
from graph_physics_tpu_torch.models.normalizer import Normalizer
from graph_physics_tpu_torch.ops.segment import segment_sum
from graph_physics_tpu_torch.utils.convert import load_mlp
from tests.helpers import tiny_graph

TOL = dict(rtol=1e-5, atol=1e-5)
PORT_DIR = Path(__file__).resolve().parents[1] / "graph_physics_tpu_torch"


def np_mlp_params(rng, in_size, hidden, out_size, n_layers=4, layer_norm=True):
    """flax MLP parameter tree drawn with numpy."""
    p = {}
    fan_in = in_size
    for i in range(n_layers):
        out = out_size if i == n_layers - 1 else hidden
        p[f"Dense_{i}"] = {
            "kernel": (rng.normal(size=(fan_in, out)) / np.sqrt(fan_in)).astype(np.float32),
            "bias": (0.1 * rng.normal(size=out)).astype(np.float32),
        }
        fan_in = out
    if layer_norm:
        p["RMSNorm_0"] = {"scale": (1.0 + 0.1 * rng.normal(size=out_size)).astype(np.float32)}
    return p


def port_mlp(params, in_size, hidden, out_size, dtype=torch.float32, activation="relu"):
    n_layers = len([k for k in params if k.startswith("Dense_")])
    m = tlayers.MLP(in_size, hidden, out_size, n_layers, "RMSNorm_0" in params,
                    activation, dtype)
    load_mlp(m, params)
    return m


def t(a):
    return torch.as_tensor(np.asarray(a))


def test_gelu_matches_jax():
    x = (3.0 * np.random.default_rng(0).normal(size=(64, 32))).astype(np.float32)
    np.testing.assert_allclose(tlayers.gelu_exact(t(x)).numpy(),
                               np.asarray(jlayers.gelu_exact(jnp.asarray(x))), **TOL)


def test_rmsnorm_matches_flax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(40, 4, 32)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=32)).astype(np.float32)
    want = jlayers.RMSNorm(32).apply({"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x))
    norm = tlayers.RMSNorm(32)
    with torch.no_grad():
        norm.scale.copy_(t(scale))
    np.testing.assert_allclose(norm(t(x)).detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("layer_norm,activation", [(True, "relu"), (False, "relu"),
                                                    (True, "gelu")])
def test_mlp_matches_flax(layer_norm, activation):
    rng = np.random.default_rng(2)
    params = np_mlp_params(rng, 11, 32, 32, layer_norm=layer_norm)
    x = rng.normal(size=(50, 3, 11)).astype(np.float32)
    mlp = jlayers.MLP(hidden_size=32, out_size=32, layer_norm=layer_norm, activation=activation)
    want = mlp.apply({"params": params}, jnp.asarray(x))
    got = port_mlp(params, 11, 32, 32, activation=activation)(t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_mlp_state_dict_follows_reference_layout():
    mlp = tlayers.MLP(3, 32, 32)
    assert sorted(mlp.state_dict()) == [
        "0.bias", "0.weight", "2.bias", "2.weight", "4.bias", "4.weight",
        "6.bias", "6.weight", "7.scale"]


@pytest.mark.parametrize("packed", [False, True])
def test_graphnet_block_plain_path_matches_jax(packed):
    g = tiny_graph(nx=14, ny=10)
    rng = np.random.default_rng(3)
    h, b = 32, 3
    n, e = g.x.shape[0], g.senders.shape[0]
    lead_n, lead_e = ((n, b), (e, b)) if packed else ((n,), (e,))
    x = rng.normal(size=lead_n + (h,)).astype(np.float32)
    ea = rng.normal(size=lead_e + (h,)).astype(np.float32)
    params = {"edge_block": np_mlp_params(rng, 3 * h, h, h),
              "node_block": np_mlp_params(rng, 2 * h, h, h)}
    jx, je = jlayers.GraphNetBlock(hidden_size=h).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(ea), jnp.asarray(g.senders),
        jnp.asarray(g.receivers), jnp.asarray(g.edge_mask))
    block = tlayers.GraphNetBlock(h)
    load_mlp(block.edge_block, params["edge_block"])
    load_mlp(block.node_block, params["node_block"])
    with torch.no_grad():
        tx, te = block(t(x), t(ea), t(g.senders), t(g.receivers), t(g.edge_mask))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **TOL)


def test_segment_sum_masks_padded_edges():
    vals = torch.arange(12, dtype=torch.float32).view(4, 3)
    ids = torch.tensor([0, 2, 2, 3], dtype=torch.int32)
    mask = torch.tensor([True, True, False, True])
    out = segment_sum(vals, ids, 4, mask=mask)
    want = torch.tensor([[0, 1, 2], [0, 0, 0], [3, 4, 5], [9, 10, 11]], dtype=torch.float32)
    assert torch.equal(out, want)


def test_normalizer_matches_jax():
    rng = np.random.default_rng(4)
    mask = rng.random((60, 4)) > 0.2
    state = jnorm.normalizer_init(5)
    norm = Normalizer(5)
    for scale in (1.0, 3.0):
        data = (scale * rng.normal(size=(60, 4, 5)) + 2.0).astype(np.float32)
        want, state = jnorm.normalize(state, jnp.asarray(data), jnp.asarray(mask),
                                      accumulate=True)
        got = norm.normalize(t(data), t(mask), accumulate=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(norm._acc_sum.numpy(), np.asarray(state.acc_sum), rtol=1e-5)
    np.testing.assert_allclose(norm._acc_sum_squared.numpy(), np.asarray(state.acc_sum_sq),
                               rtol=1e-5)
    assert float(norm._acc_count) == float(state.acc_count)
    assert float(norm._num_accumulations) == float(state.num_accumulations) == 2.0
    y = rng.normal(size=(60, 4, 5)).astype(np.float32)
    np.testing.assert_allclose(norm.inverse(t(y)).numpy(),
                               np.asarray(jnorm.normalizer_inverse(state, jnp.asarray(y))),
                               **TOL)


def test_fresh_normalizer_std_is_epsilon():
    norm = Normalizer(3)
    mean, std = norm.mean_std()
    assert torch.equal(mean, torch.zeros(3))
    assert torch.allclose(std, torch.full((3,), 1e-8))


def test_port_imports_no_jax():
    """Importing every module of the port leaves jax, flax and the JAX
    package out of sys.modules (the card's machine has no jax)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import graph_physics_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'graph_physics_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(PORT_DIR.parent), timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


@pytest.mark.parametrize("module", [
    "ops/edge_attention.py", "ops/fused_edge_attention_nk.py", "ops/fused_ffn.py",
    "ops/kernel_build.py", "models/layers.py", "models/processors.py", "entry.py",
    "ops/gumbel.py", "models/transolver.py"])
def test_import_checks_cover_the_module(module):
    """The two checks around this one walk every file of the package, the
    transformer slice's modules and kernel sources among them."""
    assert (PORT_DIR / module).is_file()
    assert (PORT_DIR / module) in set(PORT_DIR.rglob("*.py"))
    if module.startswith(("ops/fused_", "ops/gumbel")):
        src = module[len("ops/"):-len(".py")] + ".cu"
        assert (PORT_DIR / "csrc" / src).is_file(), src


def test_port_sources_import_nothing_from_jax_package():
    """No module of the port imports jax, flax or graph_physics_tpu, even
    inside a function."""
    files = sorted(PORT_DIR.rglob("*.py"))
    assert files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in ("jax", "flax", "graph_physics_tpu"), (
                    f"{path.name} imports {name}")
