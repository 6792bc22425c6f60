"""Deterministic synthetic CylinderFlow-like trajectories, kept in memory.

Copies of graph_physics_tpu/dataset/synthetic.py:grid_mesh,
node_types_for, velocity_field and make_trajectory: a triangulated
rectangle with INFLOW/OUTFLOW/WALL node types and a smooth analytic
velocity field. :func:`meta_dict` and :func:`write_h5_dataset` (copies
of the JAX package's) write such trajectories as an h5 dataset and its
meta.json, for the tests and the CLI recipe; h5py is imported only there.
:func:`make_plate_trajectory`, :func:`plate_meta_dict` and
:func:`write_plate_h5_dataset` are the DeformingPlate-like counterparts
(a sheet and a descending obstacle bar, the 3-D ``world_pos`` target).
:func:`make_panels_trajectory` and :func:`make_aneurysm_trajectory` are
the panels and aneurysm trajectories of the canonical workloads, and
:func:`write_workload_fixture` writes either as an xdmf dataset (through
utils/xdmf.XdmfTimeSeriesWriter).

:func:`graded_mesh` and :func:`make_graded_trajectory` are a fixture of
the port's own: a degree-graded Delaunay mesh around a cylinder, made
from a seed, standing in for the reference's airfoil mesh, which the repo
does not hold.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from graph_physics_tpu_torch.core.nodetype import NodeType


def grid_mesh(nx: int = 12, ny: int = 8, lx: float = 1.6, ly: float = 0.4):
    """Structured triangulated rectangle: returns (pos [N,2], cells [C,3])."""
    xs = np.linspace(0.0, lx, nx)
    ys = np.linspace(0.0, ly, ny)
    xx, yy = np.meshgrid(xs, ys, indexing="ij")
    pos = np.stack([xx.ravel(), yy.ravel()], axis=-1).astype(np.float32)
    cells = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            a = i * ny + j
            b = (i + 1) * ny + j
            c = (i + 1) * ny + j + 1
            d = i * ny + j + 1
            cells.append([a, b, c])
            cells.append([a, c, d])
    return pos, np.asarray(cells, dtype=np.int32)


def node_types_for(pos: np.ndarray, lx: float = 1.6, ly: float = 0.4) -> np.ndarray:
    t = np.full(pos.shape[0], int(NodeType.NORMAL), dtype=np.int32)
    eps = 1e-6
    t[np.abs(pos[:, 1]) < eps] = int(NodeType.WALL_BOUNDARY)
    t[np.abs(pos[:, 1] - ly) < eps] = int(NodeType.WALL_BOUNDARY)
    t[np.abs(pos[:, 0]) < eps] = int(NodeType.INFLOW)
    t[np.abs(pos[:, 0] - lx) < eps] = int(NodeType.OUTFLOW)
    return t


def velocity_field(pos: np.ndarray, t: float) -> np.ndarray:
    """Smooth analytic 2D velocity evolving in time (deterministic)."""
    x, y = pos[:, 0], pos[:, 1]
    u = 1.0 + 0.3 * np.sin(2 * np.pi * (x - 0.5 * t)) * np.cos(np.pi * y)
    v = 0.2 * np.cos(2 * np.pi * (x - 0.5 * t)) * np.sin(np.pi * y)
    return np.stack([u, v], axis=-1).astype(np.float32)


def make_trajectory(
    nx: int = 12,
    ny: int = 8,
    num_steps: int = 12,
    dt: float = 0.01,
) -> Dict[str, np.ndarray]:
    """One trajectory dict in the reference h5 field layout ([T, N, C])."""
    pos, cells = grid_mesh(nx, ny)
    types = node_types_for(pos)
    vel = np.stack([velocity_field(pos, k * dt) for k in range(num_steps)], axis=0)
    return {
        "cells": np.repeat(cells[None], num_steps, axis=0).astype(np.int32),
        "mesh_pos": np.repeat(pos[None], num_steps, axis=0).astype(np.float32),
        "node_type": np.repeat(types[None, :, None], num_steps, axis=0).astype(np.int32),
        "velocity": vel.astype(np.float32),
    }


def meta_dict(num_steps: int, dt: float = 0.01) -> Dict:
    """meta.json of dataset_config/cylinder_meta.json's schema
    (graph_physics_tpu/dataset/synthetic.py:meta_dict)."""
    def feat(typ, c, dtype):
        return {"type": typ, "shape": [num_steps, -1, c], "dtype": dtype}

    return {
        "dt": dt,
        "features": {
            "cells": feat("static", 3, "int32"),
            "mesh_pos": feat("static", 2, "float32"),
            "node_type": feat("static", 1, "int32"),
            "velocity": feat("dynamic", 2, "float32"),
        },
        "field_names": ["cells", "mesh_pos", "node_type", "velocity"],
        "trajectory_length": num_steps,
    }


def write_h5_dataset(path: str, num_trajectories: int = 2, nx: int = 12, ny: int = 8,
                     num_steps: int = 12, dt: float = 0.01,
                     meta_path: Optional[str] = None) -> Tuple[str, str]:
    """Write trajectories (trajectory i on an (nx + i) x ny mesh, so the
    buckets differ) and meta.json; returns (h5_path, meta_path)
    (graph_physics_tpu/dataset/synthetic.py:write_h5_dataset)."""
    from graph_physics_tpu_torch.dataset.h5_dataset import import_h5py

    h5py = import_h5py("dataset/synthetic.write_h5_dataset")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        for i in range(num_trajectories):
            traj = make_trajectory(nx + i, ny, num_steps, dt)
            g = f.create_group(str(i))
            for k, v in traj.items():
                g.create_dataset(k, data=v)
    meta_path = meta_path or os.path.join(os.path.dirname(path) or ".", "meta.json")
    with open(meta_path, "w") as f:
        json.dump(meta_dict(num_steps, dt), f)
    return path, meta_path


def make_plate_trajectory(nx: int = 8, ny: int = 6, num_steps: int = 8,
                          dt: float = 0.01, descent: float = 0.01) -> Dict[str, np.ndarray]:
    """DeformingPlate-like Lagrangian trajectory with a ``world_pos``
    target (copy of graph_physics_tpu/dataset/synthetic.py:
    make_plate_trajectory :83): a sheet of NORMAL nodes at z=0 (one HANDLE
    edge) and a bar of 6 OBSTACLE nodes above it that descends ``descent``
    (JAX's 0.01) a frame, the sheet deflecting under it. The cells cover
    the sheet only: the obstacle's nodes join the graph through world
    edges alone. Other descents give trajectories of the same mesh whose
    contacts differ."""
    pos2d, cells = grid_mesh(nx, ny, 1.0, 0.6)
    n_sheet = len(pos2d)
    sheet = np.concatenate([pos2d, np.zeros((n_sheet, 1))], axis=1)
    n_obs = 6
    obs_x = np.linspace(0.3, 0.7, n_obs)
    obs0 = np.stack([obs_x, np.full(n_obs, 0.3), np.full(n_obs, 0.08)], axis=1)
    pos = np.concatenate([sheet, obs0]).astype(np.float32)
    n = len(pos)
    types = np.full(n, int(NodeType.NORMAL), np.int32)
    types[:n_sheet][np.abs(pos2d[:, 0]) < 1e-6] = int(NodeType.HANDLE)
    types[n_sheet:] = int(NodeType.OBSTACLE)

    world = np.zeros((num_steps, n, 3), np.float32)
    for k in range(num_steps):
        w = pos.copy()
        drop = descent * k
        w[n_sheet:, 2] -= drop  # the obstacle descends
        d = np.linalg.norm(pos[:n_sheet, None, :2] - w[None, n_sheet:, :2], axis=-1).min(axis=1)
        deflect = np.clip(0.08 - drop - d * 0.2, a_min=None, a_max=0.0)
        w[:n_sheet, 2] += np.where(d < 0.2, deflect * 0.5, 0.0)
        world[k] = w
    return {
        "cells": np.repeat(cells[None], num_steps, axis=0).astype(np.int32),
        "mesh_pos": np.repeat(pos[None], num_steps, axis=0).astype(np.float32),
        "node_type": np.repeat(types[None, :, None], num_steps, axis=0).astype(np.int32),
        "world_pos": world,
    }


def plate_meta_dict(num_steps: int, dt: float = 0.01) -> Dict:
    """The meta.json of :func:`write_plate_h5_dataset`'s trajectories."""
    return {
        "dt": dt,
        "features": {
            "cells": {"type": "static", "shape": [num_steps, -1, 3], "dtype": "int32"},
            "mesh_pos": {"type": "static", "shape": [num_steps, -1, 3], "dtype": "float32"},
            "node_type": {"type": "static", "shape": [num_steps, -1, 1], "dtype": "int32"},
            "world_pos": {"type": "dynamic", "shape": [num_steps, -1, 3], "dtype": "float32"},
        },
        "field_names": ["cells", "mesh_pos", "node_type", "world_pos"],
        "trajectory_length": num_steps,
    }


def write_plate_h5_dataset(path: str, num_trajectories: int = 2, nx: int = 8, ny: int = 6,
                           num_steps: int = 8, dt: float = 0.01,
                           meta_path: Optional[str] = None) -> Tuple[str, str]:
    """Write plate trajectories (trajectory i on an (nx + i) x ny sheet) and
    their meta.json; returns (h5_path, meta_path)
    (synthetic.py:write_plate_h5_dataset :134)."""
    from graph_physics_tpu_torch.dataset.h5_dataset import import_h5py

    h5py = import_h5py("dataset/synthetic.write_plate_h5_dataset")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        for i in range(num_trajectories):
            g = f.create_group(str(i))
            for k, v in make_plate_trajectory(nx + i, ny, num_steps, dt).items():
                g.create_dataset(k, data=v)
    meta_path = meta_path or os.path.join(os.path.dirname(path) or ".", "plate_meta.json")
    with open(meta_path, "w") as f:
        json.dump(plate_meta_dict(num_steps, dt), f)
    return path, meta_path


def graded_mesh(num_nodes: int = 27_000, seed: int = 0, lx: float = 1.6, ly: float = 0.4,
                center=(0.3, 0.2), radius: float = 0.05, growth: float = 12.0):
    """A graded 2-D triangle mesh around a cylinder: returns (pos [N, 2],
    cells [C, 3]) with exactly ``num_nodes`` nodes, made from ``seed``.

    It stands in for the reference's airfoil fixture (27k nodes, 160k
    directed edges; tests/test_real_mesh_tiling.py, scripts/bench_airfoil.py
    read it), which the repo does not hold. The target spacing grows
    linearly with the distance d to the cylinder, h = h0·(1 + growth·d);
    nodes are the cylinder's surface ring and the rectangle's edges at that
    spacing, and interior points drawn uniformly and kept with probability
    (h0/h)², up to ``num_nodes``. The cells are the Delaunay triangles of
    those points (scipy.spatial) outside the cylinder. Random points give
    the long in-degree tail of a graded mesh. Nodes come sorted along x,
    then y, so a 128-receiver block's senders stay in a narrow band.

    At the defaults: 27,000 nodes, 160,612 directed edges, in-degree 2 to
    13 (mean 5.95, 99th percentile 9). JAX's FusedTopologyManager
    (graph_physics_tpu/training/fused.py) rejects the NK layout for it in
    both modes (``nk_layout=True``, and ``build_nk=True`` for attention)
    and serves it with the CSR kernel, with no RCM reorder (211 node
    blocks of 832 rows; checked once on the CPU). So do the 1,500- and
    1,536-node meshes of the tests (tests/test_torch_csr_layout.py checks
    the latter against JAX).
    """
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    c = np.asarray(center, np.float64)
    # h0 from the target count: the area-weighted density of the size field
    gx, gy = np.meshgrid(np.linspace(0, lx, 400), np.linspace(0, ly, 100), indexing="ij")
    d = np.maximum(np.hypot(gx - c[0], gy - c[1]) - radius, 0.0)
    outside = np.hypot(gx - c[0], gy - c[1]) > radius
    mean_inv_h2 = (outside / (1.0 + growth * d) ** 2).mean()
    # ~2/sqrt(3)·h² of area per node in an equilateral triangulation
    h0 = np.sqrt(lx * ly * mean_inv_h2 / (num_nodes * np.sqrt(3) / 2))

    def size(p):
        dist = np.maximum(np.hypot(p[:, 0] - c[0], p[:, 1] - c[1]) - radius, 0.0)
        return h0 * (1.0 + growth * dist)

    n_ring = max(int(round(2 * np.pi * radius / h0)), 8)
    ang = np.arange(n_ring) * (2 * np.pi / n_ring)
    ring = c + radius * np.stack([np.cos(ang), np.sin(ang)], axis=-1)

    def edge_points(a, b):  # a, b: corners; walk from a toward b at the local spacing
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        length = np.linalg.norm(b - a)
        ts, t = [], 0.0
        while t < length:
            ts.append(t)
            t += float(size((a + (b - a) * (t / length))[None])[0])
        return a + (b - a) * (np.asarray(ts)[:, None] / length)

    corners = [(0.0, 0.0), (lx, 0.0), (lx, ly), (0.0, ly)]
    boundary = np.concatenate([edge_points(corners[i], corners[(i + 1) % 4])
                               for i in range(4)])
    fixed = np.concatenate([ring, boundary])
    need = num_nodes - len(fixed)
    if need <= 0:
        raise ValueError(f"num_nodes {num_nodes} leaves no interior points")
    interior = np.zeros((0, 2))
    while len(interior) < need:
        cand = rng.uniform((0.0, 0.0), (lx, ly), size=(4 * need, 2))
        r = np.hypot(cand[:, 0] - c[0], cand[:, 1] - c[1])
        keep = (r > radius + 0.25 * h0) & (rng.uniform(size=len(cand))
                                           < (h0 / size(cand)) ** 2)
        # keep clear of the rectangle's edges, whose points are placed
        keep &= ((cand[:, 0] > 0.25 * h0) & (cand[:, 0] < lx - 0.25 * h0)
                 & (cand[:, 1] > 0.25 * h0) & (cand[:, 1] < ly - 0.25 * h0))
        interior = np.concatenate([interior, cand[keep]])
    pos = np.concatenate([fixed, interior[:need]])
    pos = pos[np.lexsort((pos[:, 1], pos[:, 0]))]
    cells = Delaunay(pos).simplices
    centroid = pos[cells].mean(axis=1)
    cells = cells[np.hypot(centroid[:, 0] - c[0], centroid[:, 1] - c[1]) > radius]
    return pos.astype(np.float32), cells.astype(np.int32)


def make_graded_trajectory(
    num_nodes: int = 27_000,
    num_steps: int = 12,
    dt: float = 0.01,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """:func:`make_trajectory` on :func:`graded_mesh`: the same field
    layout, node types from :func:`node_types_for` and velocity from
    :func:`velocity_field`."""
    pos, cells = graded_mesh(num_nodes, seed=seed)
    types = node_types_for(pos)
    vel = np.stack([velocity_field(pos, k * dt) for k in range(num_steps)], axis=0)
    return {
        "cells": np.repeat(cells[None], num_steps, axis=0).astype(np.int32),
        "mesh_pos": np.repeat(pos[None], num_steps, axis=0).astype(np.float32),
        "node_type": np.repeat(types[None, :, None], num_steps, axis=0).astype(np.int32),
        "velocity": vel.astype(np.float32),
    }


# ----------------------------------------------------------------------
# canonical-workload fixtures (synthetic.py:222-470)
# ----------------------------------------------------------------------

def make_aneurysm_trajectory(nx: int = 7, ny: int = 6, num_steps: int = 6,
                             dt: float = 0.01) -> Dict[str, np.ndarray]:
    """An aneurysm-meta-shaped trajectory (dataset_config/aneurysm_meta.json):
    a 3-D triangle surface, dynamic Vitesse [N, 3] and a static wall_mask
    [N, 1]; the inlet plane at y = 0 and walls on the lateral boundaries
    exercise external/aneurysm.py's node types
    (synthetic.py:make_aneurysm_trajectory)."""
    xs = np.linspace(-0.5, 0.5, nx)
    ys = np.linspace(0.0, 1.0, ny)
    xx, yy = np.meshgrid(xs, ys, indexing="ij")
    zz = 0.05 * np.sin(np.pi * yy) * np.cos(np.pi * xx)  # gentle 3D bulge
    pos = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], -1).astype(np.float32)
    _, cells = grid_mesh(nx, ny)  # same index topology

    wall = ((np.abs(pos[:, 0] - xs[0]) < 1e-6) | (np.abs(pos[:, 0] - xs[-1]) < 1e-6))
    # inlet-plane nodes are typed by the builder, not walls
    wall &= pos[:, 1] > 1e-6
    wall_mask = wall.astype(np.float32)[:, None]

    def vitesse(t):
        u = 0.1 * np.sin(2 * np.pi * (pos[:, 1] - t)) * pos[:, 0]
        v = 1.0 + 0.4 * np.cos(2 * np.pi * t) * (1.0 - np.abs(pos[:, 0]))
        w = 0.05 * np.sin(np.pi * pos[:, 1] + 4 * t)
        out = np.stack([u, v, w], -1).astype(np.float32)
        out[wall] = 0.0
        return out

    vel = np.stack([vitesse(k * dt) for k in range(num_steps)], 0)
    return {
        "cells": np.repeat(cells[None], num_steps, 0).astype(np.int32),
        "mesh_pos": np.repeat(pos[None], num_steps, 0).astype(np.float32),
        "Vitesse": vel,
        "wall_mask": np.repeat(wall_mask[None], num_steps, 0).astype(np.float32),
    }


def make_panels_trajectory(nx: int = 7, ny: int = 6, num_steps: int = 6,
                           dt: float = 0.2) -> Dict[str, np.ndarray]:
    """A panels-meta-shaped trajectory (dataset_config/panels_meta.json): a
    triangle mesh of the unit square with a zero z column, dynamic Vitesse
    [N, 3] and Pression [N, 1], static LevelSetObject and NodeType fields,
    as external/panels.py reads them (synthetic.py:make_panels_trajectory)."""
    pos2d, cells = grid_mesh(nx, ny, 1.0, 1.0)
    pos = np.concatenate([pos2d, np.zeros((len(pos2d), 1), np.float32)], -1)
    types = np.full(len(pos), int(NodeType.NORMAL), np.float32)
    types[np.abs(pos[:, 0]) < 1e-6] = float(NodeType.INFLOW)
    types[np.abs(pos[:, 0] - 1.0) < 1e-6] = float(NodeType.OUTFLOW)
    types[(np.abs(pos[:, 1]) < 1e-6) | (np.abs(pos[:, 1] - 1.0) < 1e-6)] = float(
        NodeType.WALL_BOUNDARY)
    levelset = (np.linalg.norm(pos[:, :2] - np.array([0.5, 0.5]), axis=-1) < 0.25
                ).astype(np.float32)

    def fields(t):
        u = 1.0 + 0.2 * np.sin(2 * np.pi * (pos[:, 0] - 0.3 * t))
        v = 0.1 * np.cos(2 * np.pi * (pos[:, 1] - 0.3 * t))
        p = 0.5 * np.cos(np.pi * pos[:, 0]) * np.cos(np.pi * t)
        return (np.stack([u, v, np.zeros_like(u)], -1).astype(np.float32),
                p.astype(np.float32)[:, None])

    vels, press = zip(*[fields(k * dt) for k in range(num_steps)])

    def rep(a):
        return np.repeat(a[None], num_steps, 0)

    return {
        "cells": rep(cells).astype(np.int32),
        "mesh_pos": rep(pos).astype(np.float32),
        "Vitesse": np.stack(vels, 0),
        "Pression": np.stack(press, 0),
        "LevelSetObject": rep(levelset[:, None]).astype(np.float32),
        "NodeType": rep(types[:, None]).astype(np.float32),
    }


def xdmf_meta_dict(num_steps: int, dt: float) -> Dict:
    """The meta.json of an xdmf fixture: no per-field block, the fields
    come from the files (synthetic.py:write_workload_fixture)."""
    return {"dt": dt, "trajectory_length": num_steps, "features": {}, "field_names": []}


def write_workload_fixture(workload: str, out_dir: str, num_trajectories: int = 1,
                           num_steps: int = 6, size: Optional[Tuple[int, ...]] = None
                           ) -> Tuple[str, str, str]:
    """A dataset of the aneurysm or panels workload's meta schema, one xdmf
    series per trajectory (trajectory i on an (nx + i) x ny grid) under
    ``train/`` and ``test/`` (the xdmf branch of
    synthetic.py:write_workload_fixture). ``size`` is (nx, ny). Returns
    (train_path, test_path, meta_path)."""
    if workload not in ("aneurysm", "panels"):
        raise ValueError(f"no xdmf fixture for workload {workload!r}")
    from graph_physics_tpu_torch.utils.xdmf import XdmfTimeSeriesWriter

    os.makedirs(out_dir, exist_ok=True)
    meta_path = os.path.join(out_dir, "meta.json")
    make = make_aneurysm_trajectory if workload == "aneurysm" else make_panels_trajectory
    dt = 0.01 if workload == "aneurysm" else 0.2
    with open(meta_path, "w") as f:
        json.dump(xdmf_meta_dict(num_steps, dt), f)
    for split, n in (("train", num_trajectories), ("test", 1)):
        d = os.path.join(out_dir, split)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            gnx, gny = size or (7, 6)
            traj = make(gnx + i, gny, num_steps, dt)
            w = XdmfTimeSeriesWriter(os.path.join(d, f"traj_{i}.xdmf"))
            point_fields = [k for k in traj.keys() if k not in ("cells", "mesh_pos")]
            for s in range(num_steps):
                w.append(traj["mesh_pos"][s], traj["cells"][s],
                         {k: traj[k][s].astype(np.float64) for k in point_fields}, s * dt)
    return os.path.join(out_dir, "train"), os.path.join(out_dir, "test"), meta_path
