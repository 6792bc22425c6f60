"""The port's brute-force searches (graph_physics_tpu_torch/ops/knn.py)
against the JAX package's (graph_physics_tpu/ops/knn.py), same numpy
inputs, on the CPU:

  * ``radius_edges``: equal index arrays and masks (exact), on a regular
    grid of exactly representable positions, where equal distances are
    everywhere and the ``k_per_node`` cap or the budget binds, in one search
    and batched over a leading axis; the fair (rank-major) budget of JAX's
    tests/test_world_edges_e2e.py:259; the row-blocked search on a large
    point set (:212), whose tiles change nothing;
  * ``knn``, ``knn_graph`` and ``knn_interpolate``: equal indices and
    distances (exact), interpolation to fp32 rounding (1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.ops import knn as j_knn
from graph_physics_tpu_torch.ops import knn as t_knn


def _grid(nx=12, ny=10, h=0.125):
    """A regular grid of exactly representable positions (z = 0): every
    product and sum of the distance expansion is exact, so both packages
    see the same distances and their ties."""
    g = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij"), -1).reshape(-1, 2)
    return np.concatenate([g * h, np.zeros((len(g), 1))], 1).astype(np.float32)


def _masks(n, seed=0, share=0.3):
    a = np.random.default_rng(seed).random(n) < share
    return a, ~a


def _assert_same(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.dtype == {np.dtype(np.int32): torch.int32,
                           np.dtype(bool): torch.bool}[w.dtype]
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("radius,budget,k", [
    (0.2, 64, 4),     # the budget binds
    (0.3, 1000, 16),  # the cap binds (ties at the cap's edge)
    (0.26, 37, 3),    # both bind
    (0.13, 500, 16),  # neither: every in-radius pair
])
def test_radius_edges_match_jax_on_a_grid_with_ties(radius, budget, k):
    pos = _grid()
    ma, mb = _masks(len(pos))
    want = j_knn.radius_edges(jnp.asarray(pos), jnp.asarray(pos), radius, budget,
                              mask_a=jnp.asarray(ma), mask_b=jnp.asarray(mb), k_per_node=k,
                              with_stats=True)
    got = t_knn.radius_edges(torch.tensor(pos), torch.tensor(pos), radius, budget,
                             mask_a=torch.tensor(ma), mask_b=torch.tensor(mb), k_per_node=k,
                             with_stats=True)
    _assert_same(want, got)
    assert 0 < int(got[2].sum())


def test_radius_edges_batched_equal_each_search():
    """A leading batch axis: one independent search per sample, each
    JAX's; shared [N] masks and per-sample [B, N] masks."""
    rng = np.random.default_rng(3)
    base = _grid(9, 8)
    pos = np.repeat(base[None], 3, axis=0)
    pos[..., :2] += 0.125 * rng.integers(-1, 2, size=pos[..., :2].shape)  # exact moves
    ma = np.stack([_masks(len(base), s)[0] for s in range(3)])
    got_shared = t_knn.radius_edges(torch.tensor(pos), torch.tensor(pos), 0.2, 48,
                                    mask_a=torch.tensor(ma[0]), mask_b=torch.tensor(~ma[0]),
                                    k_per_node=4)
    got = t_knn.radius_edges(torch.tensor(pos), torch.tensor(pos), 0.2, 48,
                             mask_a=torch.tensor(ma), mask_b=torch.tensor(~ma), k_per_node=4)
    for b in range(3):
        for masks, res in (((ma[0], ~ma[0]), got_shared), ((ma[b], ~ma[b]), got)):
            want = j_knn.radius_edges(jnp.asarray(pos[b]), jnp.asarray(pos[b]), 0.2, 48,
                                      mask_a=jnp.asarray(masks[0]), mask_b=jnp.asarray(masks[1]),
                                      k_per_node=4)
            _assert_same(want, [t[b] for t in res])


def test_radius_edges_fair_budget_no_starvation():
    """JAX's tests/test_world_edges_e2e.py:259 on both packages: a budget
    of 4 against 21 in-radius pairs of a dense cluster still holds the far
    obstacle's one pair, and the port picks JAX's pairs."""
    rng = np.random.default_rng(1)
    dense = rng.uniform(-0.05, 0.05, (20, 3)).astype(np.float32)
    pos_a = np.array([[0, 0, 0], [5.02, 0, 0]], np.float32)
    pos_b = np.concatenate([dense, np.array([[5.0, 0.0, 0.0]], np.float32)])
    want = j_knn.radius_edges(jnp.asarray(pos_a), jnp.asarray(pos_b), radius=0.1, budget=4)
    got = t_knn.radius_edges(torch.tensor(pos_a), torch.tensor(pos_b), radius=0.1, budget=4)
    _assert_same(want, got)
    assert 1 in set(got[0][got[2]].tolist())


def test_radius_edges_row_blocks_on_a_large_point_set():
    """JAX's :212 at 6,000 points: the port's search in tiles of at most
    2^18 distances (43 rows) equals JAX's in its own default tiles, and
    every pair lies within the radius; a sparse obstacle's in-radius
    partners (fewer than the cap) are all found (scipy's cKDTree)."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(0)
    n = 6000
    pos = rng.uniform(0, 6.0, (n, 3)).astype(np.float32)
    obs = rng.choice(n, 50, replace=False)
    ma = np.zeros(n, bool)
    ma[obs] = True
    want = j_knn.radius_edges(jnp.asarray(pos), jnp.asarray(pos), 0.35, 512,
                              mask_a=jnp.asarray(ma), mask_b=jnp.asarray(~ma))
    got = t_knn.radius_edges(torch.tensor(pos), torch.tensor(pos), 0.35, 512,
                             mask_a=torch.tensor(ma), mask_b=torch.tensor(~ma),
                             max_block_elems=1 << 18)
    _assert_same(want, got)
    a, b, v = (t.numpy() for t in got)
    assert v.any() and ma[a[v]].all() and (~ma[b[v]]).all()
    assert (((pos[a[v]] - pos[b[v]]) ** 2).sum(-1) <= 0.35 ** 2 + 1e-6).all()
    tree = cKDTree(pos[~ma])
    b_ids = np.where(~ma)[0]
    pairs = set(zip(a[v].tolist(), b[v].tolist()))
    for i in obs[:10]:
        nbrs = tree.query_ball_point(pos[i], 0.35)
        if len(nbrs) <= 16:
            assert all((int(i), int(b_ids[j])) in pairs for j in nbrs)


@pytest.mark.parametrize("exclude_self,masked", [(False, False), (True, False), (True, True)])
def test_knn_matches_jax_with_ties(exclude_self, masked):
    pos = _grid(7, 6)
    mask = _masks(len(pos), 2, 0.7)[0] if masked else None
    want = j_knn.knn(jnp.asarray(pos), jnp.asarray(pos), 6,
                     ref_mask=None if mask is None else jnp.asarray(mask),
                     exclude_self=exclude_self)
    got = t_knn.knn(torch.tensor(pos), torch.tensor(pos), 6,
                    ref_mask=None if mask is None else torch.tensor(mask),
                    exclude_self=exclude_self)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_knn_graph_and_interpolate_match_jax():
    pos = _grid(7, 6)
    mask = _masks(len(pos), 4, 0.8)[0]
    want = j_knn.knn_graph(jnp.asarray(pos), 4, node_mask=jnp.asarray(mask))
    got = t_knn.knn_graph(torch.tensor(pos), 4, node_mask=torch.tensor(mask))
    _assert_same(want, got)
    rng = np.random.default_rng(5)
    x_ref = rng.normal(size=(len(pos), 3)).astype(np.float32)
    query = (pos[::3] + 0.03).astype(np.float32)
    want = j_knn.knn_interpolate(jnp.asarray(x_ref), jnp.asarray(pos), jnp.asarray(query), k=3,
                                 ref_mask=jnp.asarray(mask))
    got = t_knn.knn_interpolate(torch.tensor(x_ref), torch.tensor(pos), torch.tensor(query),
                                k=3, ref_mask=torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
