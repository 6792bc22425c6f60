"""VTU (VTK XML unstructured grid) writer and reader, ASCII.

Counterpart of graph_physics_tpu/utils/vtu.py (:20-136): ``write_vtu``,
``graph_to_vtu``, ``read_vtu`` and ``vtu_to_xdmf`` (the reference's
meshio export, meshio_mesh.py:13-117). Positions are padded to 3-D, cells
are triangles (VTK type 5) or tetrahedra (10), and a graph's x and y
columns are written as point data ``x{i}`` / ``y{i}``. The XML goes
through the standard library's ``xml.etree.ElementTree`` where JAX's uses
lxml: the files read back through either reader to the same arrays.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

_VTK_CELL = {3: 5, 4: 10}  # triangle, tetrahedron


def _data_array(parent, name: str, arr: np.ndarray, ncomp: Optional[int] = None):
    arr = np.asarray(arr)
    attrs = {"type": "Float64" if arr.dtype.kind == "f" else "Int64", "Name": name,
             "format": "ascii"}
    if ncomp:
        attrs["NumberOfComponents"] = str(ncomp)
    el = ET.SubElement(parent, "DataArray", attrs)
    el.text = " ".join(map(repr, arr.ravel().tolist()))
    return el


def write_vtu(path: str, pos: np.ndarray, cells: np.ndarray,
              point_data: Optional[Dict[str, np.ndarray]] = None) -> str:
    """One mesh and its point data as an ASCII ``.vtu`` file (vtu.py:write_vtu)."""
    pos = np.asarray(pos, np.float64)
    if pos.shape[1] < 3:
        pos = np.concatenate([pos, np.zeros((len(pos), 3 - pos.shape[1]))], axis=1)
    cells = np.asarray(cells, np.int64)
    nv = cells.shape[1]
    root = ET.Element("VTKFile", {"type": "UnstructuredGrid", "version": "0.1",
                                  "byte_order": "LittleEndian"})
    grid = ET.SubElement(root, "UnstructuredGrid")
    piece = ET.SubElement(grid, "Piece", {"NumberOfPoints": str(len(pos)),
                                          "NumberOfCells": str(len(cells))})
    _data_array(ET.SubElement(piece, "Points"), "Points", pos, ncomp=3)
    cl = ET.SubElement(piece, "Cells")
    _data_array(cl, "connectivity", cells)
    _data_array(cl, "offsets", np.arange(1, len(cells) + 1) * nv)
    _data_array(cl, "types", np.full(len(cells), _VTK_CELL[nv], np.int64))
    if point_data:
        pd = ET.SubElement(piece, "PointData")
        for name, arr in point_data.items():
            arr = np.asarray(arr, np.float64)
            _data_array(pd, name, arr, ncomp=arr.shape[1] if arr.ndim > 1 else None)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tree = ET.ElementTree(root)
    ET.indent(tree)
    tree.write(path, xml_declaration=True, encoding="utf-8")
    return path


def graph_to_vtu(path: str, graph, extra_fields: Optional[Dict] = None) -> str:
    """A padded host MeshGraph's valid nodes and cells as a ``.vtu``, its
    x and y columns as ``x{i}`` / ``y{i}`` (vtu.py:graph_to_vtu)."""
    n = int(graph.n_node) if graph.n_node is not None else graph.x.shape[0]
    if graph.faces is None:
        raise ValueError("graph carries no cells")
    c = (int(np.sum(np.asarray(graph.face_mask))) if graph.face_mask is not None
         else len(graph.faces))
    fields: Dict[str, np.ndarray] = {}
    x = np.asarray(graph.x)[:n]
    for i in range(x.shape[1]):
        fields[f"x{i}"] = x[:, i]
    if graph.y is not None:
        y = np.asarray(graph.y)[:n]
        for i in range(y.shape[1]):
            fields[f"y{i}"] = y[:, i]
    if extra_fields:
        fields.update({k: np.asarray(v)[:n] for k, v in extra_fields.items()})
    return write_vtu(path, np.asarray(graph.pos)[:n], np.asarray(graph.faces)[:c], fields)


def read_vtu(path: str) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray]]:
    """(positions [N, 3], cells [C, nv] int64, {name: point data}) of a
    ``.vtu`` file (vtu.py:read_vtu)."""
    piece = ET.parse(path).getroot().find(".//Piece")

    def parse(el):
        vals = np.array((el.text or "").split(), np.float64)
        ncomp = int(el.get("NumberOfComponents", 1))
        return vals.reshape(-1, ncomp) if ncomp > 1 else vals

    pos = parse(piece.find("Points/DataArray"))
    conn = parse(piece.find("Cells/DataArray[@Name='connectivity']")).astype(np.int64)
    offsets = parse(piece.find("Cells/DataArray[@Name='offsets']")).astype(np.int64)
    cells = conn.reshape(-1, int(offsets[0]))
    point_data = {}
    pd = piece.find("PointData")
    if pd is not None:
        for el in pd.findall("DataArray"):
            point_data[el.get("Name")] = parse(el)
    return pos, cells, point_data


def vtu_to_xdmf(vtu_paths: Sequence[str], xdmf_path: str, dt: float = 1.0) -> str:
    """A series of ``.vtu`` files as one XDMF time series, frame i at time
    i·dt (vtu.py:vtu_to_xdmf); the XDMF writer needs h5py and lxml."""
    from graph_physics_tpu_torch.utils.xdmf import XdmfTimeSeriesWriter

    w = XdmfTimeSeriesWriter(xdmf_path)
    for i, p in enumerate(vtu_paths):
        pos, cells, pd = read_vtu(p)
        w.append(pos, cells, pd, i * dt)
    return w.path
