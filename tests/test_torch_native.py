"""The port's host mesh library (``csrc/meshops.cc`` through native.py)
against its plain versions and the JAX package's library, on the CPU.

  * ``faces_to_edges`` on triangles and on tetrahedra, ``k_hop`` at k = 2
    and 3: the library's arrays equal the plain versions' and JAX's
    library's, exactly;
  * ``radius_pairs`` and ``radius_cross_pairs`` within the first output
    budget and past it (the call asks again with the count it needs):
    JAX's library's pairs in JAX's order, and the plain versions' pairs
    (cKDTree) as sorted sets;
  * ``rcb_labels``: the plain version's labels
    (tests/test_torch_partition.py holds the parts to JAX's);
  * ``pack_rows``, ``repeat_rows`` and ``pack_block`` on fp32, int32 and
    bool leaves, one copy thread and several (an output of 1 MiB or more):
    the plain versions' and JAX's bytes;
  * the build: a source that does not compile raises with g++'s output;
    threads building at once leave one library and no temporary file.

Tolerance: none, every comparison is exact.
"""

import threading

import numpy as np
import pytest

from graph_physics_tpu import native as j_native
from graph_physics_tpu.dataset import synthetic as jsynth
from graph_physics_tpu_torch import native


def _triangles(nx=14, ny=10):
    pos, cells = jsynth.grid_mesh(nx, ny)[:2]
    return pos, np.asarray(cells)


def _tetrahedra(seed=0):
    """Tetrahedra of a 5x5x5 lattice: each cube split into 6, plus random
    ones with repeated corners."""
    n = 5
    idx = np.arange(n ** 3).reshape(n, n, n)
    tets = []
    for i in range(n - 1):
        for j in range(n - 1):
            for k in range(n - 1):
                c = idx[i:i + 2, j:j + 2, k:k + 2].reshape(-1)
                for a, b in ((1, 3), (3, 2), (2, 6), (6, 4), (4, 5), (5, 1)):
                    tets.append([c[0], c[a], c[b], c[7]])
    rng = np.random.default_rng(seed)
    return np.concatenate([np.asarray(tets), rng.integers(0, n ** 3, size=(40, 4))]), n ** 3


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cells", ["triangles", "tetrahedra"])
def test_faces_to_edges_matches_plain_and_jax(cells):
    if cells == "triangles":
        pos, faces = _triangles()
        n = len(pos)
    else:
        faces, n = _tetrahedra()
    got = native.faces_to_edges(faces, n)
    _same(got, native.faces_to_edges_plain(faces, n))
    _same(got, j_native.faces_to_edges(faces, n))
    assert got.shape[1] % 2 == 0 and (got[0] != got[1]).all()


@pytest.mark.parametrize("cells", ["triangles", "tetrahedra"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_k_hop_matches_plain_and_jax(cells, k):
    if cells == "triangles":
        pos, faces = _triangles()
        n = len(pos)
    else:
        faces, n = _tetrahedra()
    ei = native.faces_to_edges(faces, n)
    got = native.k_hop(ei, n, k)
    _same(got, native.k_hop_plain(ei, n, k))
    if k > 1:
        _same(got, j_native.k_hop(ei, n, k))
    else:
        _same(got, ei)


def _sorted_pairs(p):
    p = np.asarray(p)
    return p[np.lexsort((p[:, 1], p[:, 0]))]


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("radius,overflow", [(0.08, False), (0.9, True)])
def test_radius_pairs_matches_plain_and_jax(dim, radius, overflow):
    pos = np.random.default_rng(dim).uniform(0, 1, size=(300, dim)).astype(np.float32)
    got = native.radius_pairs(pos, radius)
    assert (len(got) > max(300 * 32, 1024)) == overflow
    _same(got, j_native.radius_pairs(pos, radius))
    _same(_sorted_pairs(got), native.radius_pairs_plain(pos, radius))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("radius,overflow", [(0.08, False), (0.9, True)])
def test_radius_cross_pairs_matches_plain_and_jax(dim, radius, overflow):
    rng = np.random.default_rng(10 + dim)
    a = rng.uniform(0, 1, size=(60, dim)).astype(np.float32)
    b = rng.uniform(0, 1, size=(400, dim)).astype(np.float32)
    got = native.radius_cross_pairs(a, b, radius)
    assert (len(got) > max(460 * 16, 1024)) == overflow
    _same(got, j_native.radius_cross_pairs(a, b, radius))
    _same(_sorted_pairs(got), native.radius_cross_pairs_plain(a, b, radius))


@pytest.mark.parametrize("parts", [2, 5, 7])
def test_rcb_labels_match_plain(parts):
    pos = np.random.default_rng(parts).normal(size=(513, 3)).astype(np.float32)
    _same(native.rcb_labels(pos, parts), native.rcb_labels_plain(pos, parts))


LEAVES = {
    "fp32": lambda rng, shape: rng.normal(size=shape).astype(np.float32),
    "int32": lambda rng, shape: rng.integers(-9, 9, size=shape).astype(np.int32),
    "bool": lambda rng, shape: rng.random(size=shape) < 0.5,
}
#: (nodes, features): a small batch (one copy thread) and one of >= 1 MiB
SIZES = [(37, (3,)), (70_000, (4,))]


@pytest.mark.parametrize("dtype", sorted(LEAVES))
@pytest.mark.parametrize("nodes,tail", SIZES)
def test_pack_rows_and_repeat_rows_match_plain_and_jax(dtype, nodes, tail):
    rng = np.random.default_rng(1)
    vals = [LEAVES[dtype](rng, (nodes,) + tail) for _ in range(4)]
    got = native.pack_rows(vals)
    _same(got, native.pack_rows_plain(vals))
    _same(got, j_native.pack_rows(vals))
    rep = native.repeat_rows(vals[0], 4)
    _same(rep, native.repeat_rows_plain(vals[0], 4))
    _same(rep, np.repeat(vals[0][:, None], 4, axis=1))


@pytest.mark.parametrize("dtype", sorted(LEAVES))
@pytest.mark.parametrize("nodes,tail", SIZES)
def test_pack_block_matches_plain_and_jax(dtype, nodes, tail):
    rng = np.random.default_rng(2)
    w = tail[0]
    src = np.ascontiguousarray(LEAVES[dtype](rng, (3, nodes, w)))
    outs = [np.zeros((nodes + 5, 3, w + 3), src.dtype) for _ in range(3)]
    native.pack_block(src, outs[0], 2)
    native.pack_block_plain(src, outs[1], 2)
    assert j_native.pack_block(src, outs[2], 2)
    _same(outs[0], outs[1])
    _same(outs[0], outs[2])


def test_pack_rows_refuses_leaves_of_two_shapes():
    with pytest.raises(ValueError, match="shape or dtype"):
        native.pack_rows([np.zeros((3, 2), np.float32), np.zeros((4, 2), np.float32)])


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "meshops.cc"
    bad.write_text("extern \"C\" int broken( { return 0; }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.build()
    assert "error" in str(e.value)
    assert not list((tmp_path / "build").glob("*"))


def test_threads_building_at_once_leave_one_library(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    paths, errors = [], []

    def run():
        try:
            paths.append(native.build())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [paths[0].name]
    assert native.library_path() == paths[0]
