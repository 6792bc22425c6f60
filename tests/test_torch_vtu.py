"""The port's VTU writer and reader (utils/vtu.py, the standard library's
ElementTree) against the JAX package's (lxml), on the CPU.

  * a file the port writes reads back through JAX's ``read_vtu``, and one
    JAX writes through the port's, to the same arrays: positions padded to
    3-D, cells (types 5 and 10), point data, on triangles in 2-D and
    tetrahedra in 3-D;
  * ``graph_to_vtu`` of a padded MeshGraph writes the valid nodes and cells
    and the ``x{i}`` / ``y{i}`` columns JAX's does;
  * ``vtu_to_xdmf`` of a three-file series gives JAX's XDMF time series
    (read back with JAX's reader).

Tolerance: none (np.array_equal): ASCII floats are written with ``repr``,
which reads back to the same float64.
"""

import numpy as np
import pytest

from graph_physics_tpu.dataset import synthetic as jsynth
from graph_physics_tpu.utils import vtu as jvtu
from graph_physics_tpu.utils.xdmf import XdmfTimeSeriesReader as JReader
from graph_physics_tpu_torch.core import mesh as tmesh
from graph_physics_tpu_torch.utils import vtu as tvtu


def _mesh(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "triangles":
        pos, cells = jsynth.grid_mesh(9, 6)[:2]
        return pos.astype(np.float32), np.asarray(cells)
    pos = rng.normal(size=(30, 3))
    return pos, rng.integers(0, 30, size=(25, 4))


def _fields(n, seed=1):
    rng = np.random.default_rng(seed)
    return {"velocity": rng.normal(size=(n, 2)).astype(np.float32),
            "pressure": rng.normal(size=n)}


def _same_read(a, b):
    for x, y in zip(a[:2], b[:2]):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    assert sorted(a[2]) == sorted(b[2])
    for k in a[2]:
        np.testing.assert_array_equal(a[2][k], b[2][k])


@pytest.mark.parametrize("kind", ["triangles", "tetrahedra"])
def test_port_file_reads_back_through_jax(tmp_path, kind):
    pos, cells = _mesh(kind)
    fields = _fields(len(pos))
    path = tvtu.write_vtu(str(tmp_path / "a" / "m.vtu"), pos, cells, fields)
    got = jvtu.read_vtu(path)
    assert got[0].shape == (len(pos), 3)
    np.testing.assert_array_equal(got[0][:, :pos.shape[1]], np.asarray(pos, np.float64))
    np.testing.assert_array_equal(got[1], cells)
    np.testing.assert_array_equal(got[2]["velocity"], fields["velocity"].astype(np.float64))
    _same_read(tvtu.read_vtu(path), got)
    types = {"triangles": "5", "tetrahedra": "10"}[kind]
    text = open(path).read()
    assert f'Name="types" format="ascii">{types} ' in text


@pytest.mark.parametrize("kind", ["triangles", "tetrahedra"])
def test_jax_file_reads_back_through_the_port(tmp_path, kind):
    pos, cells = _mesh(kind, seed=3)
    path = jvtu.write_vtu(str(tmp_path / "j.vtu"), pos, cells, _fields(len(pos), seed=4))
    _same_read(tvtu.read_vtu(path), jvtu.read_vtu(path))


def _graph(with_y=True):
    pos, cells = jsynth.grid_mesh(7, 5)[:2]
    n = len(pos)
    rng = np.random.default_rng(5)
    ei = tmesh.faces_to_edges(cells, n)
    return tmesh.build_mesh_graph(rng.normal(size=(n, 3)), pos, np.zeros(n, np.int32), ei,
                                  y=rng.normal(size=(n, 2)) if with_y else None,
                                  faces=cells, n_pad=48, c_pad=64)


@pytest.mark.parametrize("with_y", [True, False])
def test_graph_to_vtu_matches_jax(tmp_path, with_y):
    g = _graph(with_y)
    extra = {"error": np.arange(g.x.shape[0], dtype=np.float64)}
    a = tvtu.graph_to_vtu(str(tmp_path / "t.vtu"), g, extra_fields=extra)
    b = jvtu.graph_to_vtu(str(tmp_path / "j.vtu"), g, extra_fields=extra)
    got, want = tvtu.read_vtu(a), jvtu.read_vtu(b)
    _same_read(got, want)
    assert got[0].shape == (35, 3) and got[1].shape == (int(g.face_mask.sum()), 3)
    assert sorted(got[2]) == sorted(["x0", "x1", "x2", "error"]
                                    + (["y0", "y1"] if with_y else []))


def test_graph_without_cells_raises(tmp_path):
    with pytest.raises(ValueError, match="no cells"):
        tvtu.graph_to_vtu(str(tmp_path / "t.vtu"), _graph().replace(faces=None))


def test_vtu_to_xdmf_matches_jax(tmp_path):
    pos, cells = _mesh("triangles")
    paths = [tvtu.write_vtu(str(tmp_path / f"s{i}.vtu"), pos, cells,
                            {"u": _fields(len(pos), seed=i)["velocity"]}) for i in range(3)]
    a = tvtu.vtu_to_xdmf(paths, str(tmp_path / "port.xdmf"), dt=0.5)
    b = jvtu.vtu_to_xdmf(paths, str(tmp_path / "jax.xdmf"), dt=0.5)
    ra, rb = JReader(a), JReader(b)
    assert len(ra) == len(rb) == 3
    for i in range(3):
        fa, fb = ra.read_frame(i), rb.read_frame(i)
        for x, y in zip(fa[:2], fb[:2]):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(fa[2]["u"], fb[2]["u"])
        assert fa[3] == fb[3] == pytest.approx(0.5 * i)
    ra.close()
    rb.close()
