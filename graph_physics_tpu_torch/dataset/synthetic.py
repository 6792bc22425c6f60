"""Deterministic synthetic CylinderFlow-like trajectories, kept in memory.

Copies of graph_physics_tpu/dataset/synthetic.py:grid_mesh,
node_types_for, velocity_field and make_trajectory: a triangulated
rectangle with INFLOW/OUTFLOW/WALL node types and a smooth analytic
velocity field. Nothing is written to disk (no h5 files).

:func:`graded_mesh` and :func:`make_graded_trajectory` are a fixture of
the port's own: a degree-graded Delaunay mesh around a cylinder, made
from a seed, standing in for the reference's airfoil mesh, which the repo
does not hold.
"""

from __future__ import annotations

from typing import Dict

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
