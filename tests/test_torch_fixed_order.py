"""The port's sums in a fixed order (ops/segment.py: ``scatter_rows``,
``gather_rows``) against ``index_add_`` and the JAX package, on the CPU.

With the same numpy inputs from a seed, in fp32, masked lanes and empty
segments included: ``segment_sum`` against ``index_add_`` (bit for bit:
the CPU branch is ``index_add_``) and JAX's ``ops/segment.segment_sum``
(1e-6); ``wscatter_sum`` and ``wtake``'s gradient against JAX's
``world_gather`` functions and ``jax.grad`` (1e-6); ``gather_rows``'s
gradient against ``index_select``'s (bit for bit) and ``jax.grad`` of
``jnp.take`` (1e-6); ``segment_softmax``'s against JAX's; and
``scatter_rows``'s card branch (``_index_put_impl_``, sorted), which also
runs on CPU tensors, against ``index_add_`` to 1e-6; the lanes off a mask
adding nothing and taking no gradient, whatever they hold.
The card's repeat of the bits is tests/test_torch_cuda.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.ops import segment as jsegment
from graph_physics_tpu.ops import world_gather as jworld
from graph_physics_tpu_torch.ops import segment
from graph_physics_tpu_torch.ops.world_gather import wscatter_sum, wtake

TOL = dict(rtol=1e-6, atol=1e-6)


def _edges(seed, e=400, n=30, f=5):
    """Values [E, F], segment ids with segments 0 and 7 empty, a mask."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(e, f)).astype(np.float32)
    ids = rng.integers(1, n, e).astype(np.int32)
    ids[ids == 7] = 8
    mask = rng.random(e) > 0.2
    return vals, ids, mask, n


@pytest.mark.parametrize("masked", [True, False])
def test_segment_sum_matches_index_add_and_jax(masked):
    vals, ids, mask, n = _edges(0)
    m = torch.as_tensor(mask) if masked else None
    got = segment.segment_sum(torch.as_tensor(vals), torch.as_tensor(ids), n, mask=m)
    kept = np.where(mask[:, None], vals, 0.0) if masked else vals
    want = torch.zeros(n, 5).index_add_(0, torch.as_tensor(ids), torch.as_tensor(kept))
    assert torch.equal(got, want)
    assert torch.equal(got[0], torch.zeros(5)) and torch.equal(got[7], torch.zeros(5))
    jwant = jsegment.segment_sum(jnp.asarray(vals), jnp.asarray(ids), n,
                                 mask=jnp.asarray(mask) if masked else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **TOL)


def test_gather_rows_gradient_matches_index_select_and_jax():
    vals, ids, _, n = _edges(1)
    rng = np.random.default_rng(2)
    src = rng.normal(size=(n, 5)).astype(np.float32)
    leaf = torch.as_tensor(src).requires_grad_(True)
    (got,) = torch.autograd.grad(segment.gather_rows(leaf, torch.as_tensor(ids)), leaf,
                                 torch.as_tensor(vals))
    leaf2 = torch.as_tensor(src).requires_grad_(True)
    (want,) = torch.autograd.grad(leaf2.index_select(0, torch.as_tensor(ids).long()), leaf2,
                                  torch.as_tensor(vals))
    assert torch.equal(got, want)
    jg = jax.grad(lambda s: jnp.sum(jnp.take(s, jnp.asarray(ids), axis=0) * vals))(
        jnp.asarray(src))
    np.testing.assert_allclose(got.numpy(), np.asarray(jg), **TOL)
    with torch.no_grad():  # no autograd: the plain gather
        assert torch.equal(segment.gather_rows(leaf, torch.as_tensor(ids)),
                           leaf.index_select(0, torch.as_tensor(ids)))


def test_segment_softmax_and_its_gradient_match_jax():
    vals, ids, mask, n = _edges(3, f=2)
    rng = np.random.default_rng(4)
    cot = rng.normal(size=vals.shape).astype(np.float32)
    leaf = torch.as_tensor(vals).requires_grad_(True)
    out = segment.segment_softmax(leaf, torch.as_tensor(ids), n, mask=torch.as_tensor(mask))
    (got,) = torch.autograd.grad(out, leaf, torch.as_tensor(cot))

    def jfn(v):
        return jsegment.segment_softmax(v, jnp.asarray(ids), n, mask=jnp.asarray(mask))

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jfn(jnp.asarray(vals))), **TOL)
    jg = jax.grad(lambda v: jnp.sum(jfn(v) * cot))(jnp.asarray(vals))
    np.testing.assert_allclose(got.numpy(), np.asarray(jg), **TOL)


def test_world_scatter_and_gather_gradient_match_jax():
    rng = np.random.default_rng(5)
    w, b, n, f = 64, 3, 20, 4
    vals = rng.normal(size=(w, b, f)).astype(np.float32)
    idx = rng.integers(0, n - 3, (w, b)).astype(np.int32)  # nodes n-3.. receive nothing
    mask = rng.random((w, b)) > 0.25
    got = wscatter_sum(torch.as_tensor(vals), torch.as_tensor(idx), n, torch.as_tensor(mask))
    want = jworld.wscatter_sum(jnp.asarray(vals), jnp.asarray(idx), n, jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(got[n - 3:], torch.zeros(3, b, f))
    arr = rng.normal(size=(n, b, f)).astype(np.float32)
    leaf = torch.as_tensor(arr).requires_grad_(True)
    (tg,) = torch.autograd.grad(wtake(leaf, torch.as_tensor(idx)), leaf, torch.as_tensor(vals))
    jg = jax.grad(lambda a: jnp.sum(jworld.wtake(a, jnp.asarray(idx)) * vals))(jnp.asarray(arr))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)


def test_card_branch_of_scatter_rows_matches_index_add():
    """The card's ``_index_put_impl_(..., accumulate=True, unsafe=True)`` on
    CPU tensors (the CPU's own kernel of the same op): the same sums to
    1e-6 of ``index_add_``'s, and its gradient a gather."""
    vals, ids, _, n = _edges(6)
    v, i = torch.as_tensor(vals), torch.as_tensor(ids)
    got = torch.ops.aten._index_put_impl_(torch.zeros(n, 5), [i.long()], v, True, True)
    want = torch.zeros(n, 5).index_add_(0, i, v)
    torch.testing.assert_close(got, want, **TOL)
    leaf = v.clone().requires_grad_(True)
    g = torch.as_tensor(np.random.default_rng(7).normal(size=(n, 5)).astype(np.float32))
    (dv,) = torch.autograd.grad(segment.scatter_rows(leaf, i, n), leaf, g)
    assert torch.equal(dv, g.index_select(0, i))


def test_lanes_off_the_mask_add_nothing_and_take_no_gradient():
    """``scatter_rows`` with a mask and values left in the lanes off it: the
    sums of the kept lanes (bit for bit ``index_add_`` of the zeroed
    values, as the card's spare rows give), a zero gradient in the lanes
    off it; ``gather_rows`` with a mask drops those lanes' cotangent."""
    vals, ids, mask, n = _edges(8)
    v, i, m = torch.as_tensor(vals), torch.as_tensor(ids), torch.as_tensor(mask)
    kept = torch.where(m[:, None], v, 0.0)
    leaf = v.clone().requires_grad_(True)
    got = segment.scatter_rows(leaf, i, n, m)
    assert torch.equal(got, torch.zeros(n, 5).index_add_(0, i, kept))
    g = torch.as_tensor(np.random.default_rng(9).normal(size=(n, 5)).astype(np.float32))
    (dv,) = torch.autograd.grad(got, leaf, g)
    assert torch.equal(dv, torch.where(m[:, None], g.index_select(0, i), 0.0))
    src = torch.as_tensor(np.random.default_rng(10).normal(size=(n, 5)).astype(np.float32))
    src.requires_grad_(True)
    (ds,) = torch.autograd.grad(segment.gather_rows(src, i, m), src, v)
    assert torch.equal(ds, torch.zeros(n, 5).index_add_(0, i, kept))


def test_card_indices_are_checked_once_an_ids_tensor():
    """The card's scatter indices (``segment._card_ids``, device-agnostic):
    int64, the lanes off the mask in spare rows past ``num`` (so the card's
    sums are index_add_'s of the kept lanes), made once an ids tensor and
    made again, range check included, after an in-place change; an id out
    of range raises. ``world_gather.flat_ids`` is kept the same way."""
    from graph_physics_tpu_torch.ops.world_gather import flat_ids

    vals, ids, mask, n = _edges(12)
    v, i, m = torch.as_tensor(vals), torch.as_tensor(ids), torch.as_tensor(mask)
    got, rows = segment._card_ids(i, n, m)
    assert rows == n + segment.SPARE_ROWS and got.dtype == torch.int64
    assert segment._card_ids(i, n, m)[0] is got
    sums = torch.zeros(rows, 5).index_add_(0, got, v)[:n]
    assert torch.equal(sums, torch.zeros(n, 5).index_add_(0, i, torch.where(m[:, None], v, 0.0)))
    i[0] = n  # an in-place change: made and checked again
    with pytest.raises(RuntimeError):
        segment._card_ids(i, n, m)
    idx = torch.as_tensor(np.random.default_rng(13).integers(0, 20, (64, 3)))
    flat = flat_ids(idx)
    assert flat_ids(idx) is flat
    idx[0, 0] = 5
    assert flat_ids(idx) is not flat and int(flat_ids(idx)[0]) == 15
