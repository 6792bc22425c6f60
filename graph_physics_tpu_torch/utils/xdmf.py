"""XDMF time-series reader and writer (lxml + h5py).

Copy of graph_physics_tpu/utils/xdmf.py (XdmfTimeSeriesWriter,
XdmfTimeSeriesReader, write_mesh_series): XML light data beside an HDF5
heavy file (``<file>.h5:/dataN``), meshio-compatible in structure. h5py
and lxml are imported when a writer or reader is made; where one is
missing, an ImportError names the file that needed it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

_TOPOLOGY_BY_NODES = {3: "Triangle", 4: "Tetrahedron"}
_NODES_BY_TOPOLOGY = {
    "triangle": 3,
    "tetrahedron": 4,
    "tri": 3,
    "tet": 4,
}


def _imports(path: str):
    """(h5py, lxml.etree), or an ImportError naming ``path``."""
    try:
        import h5py
        from lxml import etree
    except ImportError as e:
        raise ImportError(f"the XDMF file {path} needs h5py and lxml: {e}") from e
    return h5py, etree


def _dtype_tags(a: np.ndarray) -> Tuple[str, int]:
    if np.issubdtype(a.dtype, np.integer):
        return "Int", a.dtype.itemsize
    return "Float", a.dtype.itemsize


class XdmfTimeSeriesWriter:
    """Append-friendly writer: one .xdmf XML + sibling .h5 heavy file.

    Mirrors append_mesh_to_xdmf semantics (meshio_mesh.py:161-233): each
    appended frame adds new ``data{N}`` HDF5 datasets and a cloned
    temporal-grid entry. Geometry/topology are written once per call (they
    may change per frame for remeshing datasets).
    """

    def __init__(self, path: str, compression: Optional[str] = "gzip"):
        h5py, etree = _imports(path)
        if not path.endswith(".xdmf"):
            path = path + ".xdmf"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.h5_path = os.path.splitext(path)[0] + ".h5"
        self.compression = compression
        self._h5py = h5py
        self._etree = etree
        self._counter = 0

        if os.path.exists(path):
            self.tree = etree.parse(path)
            self.collection = self.tree.find(".//Grid[@GridType='Collection']")
            with h5py.File(self.h5_path, "a") as f:
                nums = [
                    int(k[4:]) for k in f.keys() if k.startswith("data") and k[4:].isdigit()
                ]
                self._counter = max(nums) + 1 if nums else 0
        else:
            root = etree.Element("Xdmf", Version="3.0")
            domain = etree.SubElement(root, "Domain")
            self.collection = etree.SubElement(
                domain,
                "Grid",
                Name="TimeSeries",
                GridType="Collection",
                CollectionType="Temporal",
            )
            self.tree = etree.ElementTree(root)

    # ------------------------------------------------------------------
    def _write_h5(self, arr: np.ndarray) -> str:
        name = f"data{self._counter}"
        self._counter += 1
        with self._h5py.File(self.h5_path, "a") as f:
            f.create_dataset(name, data=arr, compression=self.compression)
        return name

    def _data_item(self, parent, arr: np.ndarray):
        etree = self._etree
        name = self._write_h5(arr)
        dt, prec = _dtype_tags(arr)
        item = etree.SubElement(
            parent,
            "DataItem",
            DataType=dt,
            Dimensions=" ".join(str(s) for s in arr.shape),
            Format="HDF",
            Precision=str(prec),
        )
        item.text = f"{os.path.basename(self.h5_path)}:/{name}"

    def append(
        self,
        pos: np.ndarray,
        cells: np.ndarray,
        point_data: Dict[str, np.ndarray],
        time: float,
    ) -> None:
        etree = self._etree
        grid = etree.SubElement(
            self.collection, "Grid", Name=f"frame_{len(self.collection)}", GridType="Uniform"
        )
        etree.SubElement(grid, "Time", Value=repr(float(time)))

        cells = np.asarray(cells)
        topo = etree.SubElement(
            grid,
            "Topology",
            TopologyType=_TOPOLOGY_BY_NODES[cells.shape[1]],
            NumberOfElements=str(cells.shape[0]),
        )
        self._data_item(topo, cells.astype(np.int64))

        pos = np.asarray(pos, np.float64)
        if pos.shape[1] == 2:  # XDMF geometry wants 3D
            pos = np.concatenate([pos, np.zeros((len(pos), 1))], axis=1)
        geom = etree.SubElement(grid, "Geometry", GeometryType="XYZ")
        self._data_item(geom, pos)

        for name, arr in point_data.items():
            arr = np.asarray(arr)
            if arr.ndim == 1:
                arr = arr[:, None]
            at = "Scalar" if arr.shape[1] == 1 else "Vector"
            attr = etree.SubElement(
                grid, "Attribute", Name=name, AttributeType=at, Center="Node"
            )
            self._data_item(attr, arr.astype(np.float64))

        self.flush()

    def flush(self):
        self.tree.write(
            self.path, pretty_print=True, xml_declaration=True, encoding="utf-8"
        )


# ----------------------------------------------------------------------
# reader
# ----------------------------------------------------------------------

class XdmfTimeSeriesReader:
    """Read frames written by this writer or meshio's XDMF3 writer."""

    def __init__(self, path: str):
        h5py, etree = _imports(path)
        self.path = path
        self.dir = os.path.dirname(os.path.abspath(path))
        self._h5py = h5py
        self.tree = etree.parse(path)
        self.grids = self.tree.findall(
            ".//Grid[@GridType='Collection']/Grid[@GridType='Uniform']"
        )
        if not self.grids:
            # meshio sometimes omits GridType on uniform grids
            self.grids = [
                g
                for g in self.tree.findall(".//Grid[@GridType='Collection']/Grid")
            ]
        if not self.grids:
            # single-grid file (no temporal collection): one frame — the
            # layout of the reference's per-frame fixtures
            # (e.g. tests/mock_airfoil/sample_000000005.xdmf)
            self.grids = self.tree.findall(".//Domain/Grid")
        self._h5_cache: Dict[str, object] = {}

    def __len__(self):
        return len(self.grids)

    def _load_item(self, item) -> np.ndarray:
        text = (item.text or "").strip()
        if item.get("Format", "HDF").upper() in ("HDF", "HDF5"):
            fname, key = text.split(":", 1)
            fpath = os.path.join(self.dir, fname)
            if fpath not in self._h5_cache:
                self._h5_cache[fpath] = self._h5py.File(fpath, "r")
            return np.asarray(self._h5_cache[fpath][key.lstrip("/")])
        # XML inline data
        dims = [int(d) for d in item.get("Dimensions", "").split()]
        arr = np.fromstring(text, sep=" ")
        return arr.reshape(dims) if dims else arr

    def _mesh_element(self, grid, tag: str):
        """Topology/Geometry of a frame grid, resolving meshio's shared-
        mesh layout: time-series frames may carry only an XInclude
        xpointer to ``Grid[@Name="mesh"]`` instead of their own elements
        (the reference datasets are written this way by meshio)."""
        el = grid.find(tag)
        if el is not None:
            return el
        for mesh_grid in self.tree.findall(".//Grid"):
            el = mesh_grid.find(tag)
            if el is not None:
                return el
        raise ValueError(f"no {tag} element found in {self.path}")

    def read_frame(self, i: int):
        grid = self.grids[i]
        t_el = grid.find("Time")
        time = float(t_el.get("Value")) if t_el is not None else float(i)
        topo = self._mesh_element(grid, "Topology")
        cells = self._load_item(topo.find("DataItem")).astype(np.int32)
        ttype = (topo.get("TopologyType") or "").lower()
        if ttype in _NODES_BY_TOPOLOGY:
            cells = cells.reshape(-1, _NODES_BY_TOPOLOGY[ttype])
        geom = self._mesh_element(grid, "Geometry")
        pos = np.asarray(self._load_item(geom.find("DataItem")), np.float32)
        point_data = {}
        for attr in grid.findall("Attribute"):
            if (attr.get("Center") or "Node") != "Node":
                continue
            point_data[attr.get("Name")] = np.asarray(
                self._load_item(attr.find("DataItem")), np.float32
            )
        return pos, cells, point_data, time

    def num_points(self, i: int = 0) -> int:
        grid = self.grids[i]
        geom = self._mesh_element(grid, "Geometry")
        dims = geom.find("DataItem").get("Dimensions").split()
        return int(dims[0])

    def close(self):
        for f in self._h5_cache.values():
            f.close()
        self._h5_cache.clear()


def write_mesh_series(
    path: str,
    frames: List[Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray], float]],
    compression: Optional[str] = "gzip",
):
    """One-shot export: list of (pos, cells, point_data, time) → XDMF.

    Replaces meshes_to_xdmf (meshio_mesh.py:119-158).
    """
    w = XdmfTimeSeriesWriter(path, compression=compression)
    for pos, cells, point_data, time in frames:
        w.append(pos, cells, point_data, time)
    return w.path
