"""The port's discrete vector calculus (ops/voperators.py) against the JAX
package's, on the CPU, fp32, tolerance 1e-5 (relative to the largest
value): both gradient methods on 2-D triangles, 3-D surface triangles and
tetrahedra, each mesh padded with masked edges and faces, for one field
[N, F] and for a packed [N, B, F] field sample by sample; convection and
divergence of the same gradients."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_physics_tpu.dataset import synthetic as jsynth
from graph_physics_tpu.ops import voperators as jvop
from graph_physics_tpu_torch.core import mesh
from graph_physics_tpu_torch.dataset import synthetic
from graph_physics_tpu_torch.ops import voperators as tvop

TOL = 1e-5
PAD_NODES, PAD_EDGES, PAD_FACES = 5, 7, 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these small cases gain nothing from more, and a
    test worker sharing the machine with others slows down many-fold when
    each process runs one thread a core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(kind):
    """(pos [N, D], cells [C, k]) of a small mesh of ``kind``."""
    if kind == "tri2d":
        return synthetic.grid_mesh(7, 5)
    if kind == "tri3d":
        traj = synthetic.make_aneurysm_trajectory(7, 6, num_steps=2)
        return traj["mesh_pos"][0], traj["cells"][0]
    traj = jsynth.make_plate_tet_trajectory(4, 3, 3, num_steps=2)  # tetrahedra
    return traj["mesh_pos"][0], traj["cells"][0]


def _case(kind, batch, seed=0):
    """A padded mesh and a random field: numpy arrays for both packages."""
    pos, cells = _mesh(kind)
    n = len(pos)
    ei = mesh.faces_to_edges(cells, n)
    e = ei.shape[1]
    n_pad, e_pad, c_pad = n + PAD_NODES, e + PAD_EDGES, len(cells) + PAD_FACES
    rng = np.random.default_rng(seed)
    pos_p = np.zeros((n_pad, pos.shape[1]), np.float32)
    pos_p[:n] = pos
    senders = np.zeros(e_pad, np.int32)
    receivers = np.full(e_pad, n_pad - 1, np.int32)
    senders[:e], receivers[:e] = ei[0], ei[1]
    edge_mask = np.arange(e_pad) < e
    faces = np.zeros((c_pad, cells.shape[1]), np.int32)
    faces[:len(cells)] = cells
    face_mask = np.arange(c_pad) < len(cells)
    shape = (n_pad,) + ((batch,) if batch else ()) + (3,)
    field = rng.normal(size=shape).astype(np.float32)
    field[n:] = 0.0
    return dict(pos=pos_p, field=field, senders=senders, receivers=receivers,
                edge_mask=edge_mask, faces=faces, face_mask=face_mask)


def _jax_grad(c, method, field):
    return np.asarray(jvop.gradient(
        jnp.asarray(c["pos"]), jnp.asarray(field), senders=jnp.asarray(c["senders"]),
        receivers=jnp.asarray(c["receivers"]), edge_mask=jnp.asarray(c["edge_mask"]),
        faces=jnp.asarray(c["faces"]), face_mask=jnp.asarray(c["face_mask"]), method=method))


def _port_grad(c, method):
    t = {k: torch.as_tensor(v) for k, v in c.items()}
    return tvop.gradient(t["pos"], t["field"], senders=t["senders"], receivers=t["receivers"],
                         edge_mask=t["edge_mask"], faces=t["faces"], face_mask=t["face_mask"],
                         method=method)


def _close(got, want, name):
    got = np.asarray(got, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale, err_msg=name)


@pytest.mark.parametrize("method", ["finite_diff", "least_squares"])
@pytest.mark.parametrize("kind", ["tri2d", "tri3d", "tet"])
@pytest.mark.parametrize("batch", [0, 3])
def test_gradient_matches_jax(kind, method, batch):
    c = _case(kind, batch)
    got = _port_grad(c, method).numpy()
    dim = c["pos"].shape[1]
    if batch:  # JAX's function sample by sample
        want = np.stack([_jax_grad(c, method, c["field"][:, b]) for b in range(batch)], axis=1)
    else:
        want = _jax_grad(c, method, c["field"])
    assert got.shape == c["field"].shape + (dim,)
    assert np.isfinite(got).all()
    _close(got, want, f"{kind} {method}")


@pytest.mark.parametrize("kind", ["tri2d", "tri3d"])
def test_convection_and_divergence_match_jax(kind):
    c = _case(kind, 0, seed=1)
    grad_t = _port_grad(c, "least_squares")
    grad_j = jnp.asarray(_jax_grad(c, "least_squares", c["field"]))
    _close(tvop.convection(torch.as_tensor(c["field"]), grad_t).numpy(),
           np.asarray(jvop.convection(jnp.asarray(c["field"]), grad_j)), "convection")
    _close(tvop.divergence(grad_t).numpy(), np.asarray(jvop.divergence(grad_j)), "divergence")


def test_padded_faces_and_edges_add_nothing():
    """A field that is non-zero only on padding rows, which no valid edge or
    face reaches, has a zero gradient at every valid node, both methods."""
    c = _case("tri2d", 0)
    n = len(_mesh("tri2d")[0])
    c["field"] = np.zeros_like(c["field"])
    c["field"][n:] = 7.0
    for method in ("finite_diff", "least_squares"):
        assert not _port_grad(c, method)[:n].any()
