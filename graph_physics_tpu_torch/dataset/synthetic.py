"""Deterministic synthetic CylinderFlow-like trajectories, kept in memory.

Copies of graph_physics_tpu/dataset/synthetic.py:grid_mesh,
node_types_for, velocity_field and make_trajectory: a triangulated
rectangle with INFLOW/OUTFLOW/WALL node types and a smooth analytic
velocity field. Nothing is written to disk (no h5 files).
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
