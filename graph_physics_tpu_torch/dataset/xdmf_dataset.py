"""XDMF time-series dataset -> padded MeshGraph frames.

Copy of graph_physics_tpu/dataset/xdmf_dataset.py:XDMFDataset on the
port's utils/xdmf.XdmfTimeSeriesReader: a directory of ``.xdmf`` files,
one trajectory per file, each loaded whole into the h5-style field dict
(``mesh_pos``, ``cells`` and every point field, [T, N, C]). A 2-D mesh
stored with a zero z column drops it; ``node_type`` is the point field of
that name, else all NORMAL (the ``external/`` builders derive it). h5py
and lxml are imported when a file is opened. Index math and bucket
pinning come from BaseDataset.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import numpy as np

from graph_physics_tpu_torch.dataset.base import BaseDataset
from graph_physics_tpu_torch.dataset.h5_dataset import read_meta
from graph_physics_tpu_torch.dataset.preprocessing import FrameConfig
from graph_physics_tpu_torch.utils.xdmf import XdmfTimeSeriesReader


def trajectory_fields(mesh_pos: np.ndarray, cells: np.ndarray,
                      point_data: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """One trajectory's frames ([T, N, 3] positions, [T, C, k] cells, [T, N, ...]
    point fields) as the h5-style field dict the frame builder reads
    (xdmf_dataset.py:XDMFDataset._trajectory): a 2-D triangle mesh stored
    with a zero z column drops it; ``node_type`` is the point field of that
    name as int32 [T, N, 1], else all NORMAL."""
    tlen, n = mesh_pos.shape[:2]
    traj: Dict[str, np.ndarray] = {"mesh_pos": mesh_pos, "cells": cells}
    if mesh_pos.shape[-1] == 3 and np.allclose(mesh_pos[..., -1], 0) and cells.shape[-1] == 3:
        traj["mesh_pos"] = mesh_pos[..., :2]
    traj.update(point_data)
    if "node_type" not in traj:
        traj["node_type"] = np.zeros((tlen, n, 1), np.int32)
    else:
        traj["node_type"] = traj["node_type"].reshape(tlen, n, -1).astype(np.int32)
    return traj


class XDMFDataset(BaseDataset):
    def __init__(self, dataset_dir: str, meta_path: str, frame_config: FrameConfig,
                 seed: int = 0, num_partitions: Optional[int] = None,
                 max_nodes_per_partition: Optional[int] = None):
        super().__init__(frame_config, read_meta(meta_path), seed=seed,
                         num_partitions=num_partitions,
                         max_nodes_per_partition=max_nodes_per_partition)
        self.dir = dataset_dir
        self.files = sorted(glob.glob(os.path.join(dataset_dir, "*.xdmf")))
        if not self.files:
            raise FileNotFoundError(f"no .xdmf files in {dataset_dir}")
        self._traj_cache: Dict[int, Dict[str, np.ndarray]] = {}
        self._traj_len = []
        for f in self.files:
            r = XdmfTimeSeriesReader(f)
            self._traj_len.append(len(r))
            r.close()
        self._setup_index()

    @property
    def num_trajectories(self) -> int:
        return len(self.files)

    def _trajectory(self, t: int) -> Dict[str, np.ndarray]:
        """Trajectory ``t`` as the h5-style field dict
        (xdmf_dataset.py:XDMFDataset._trajectory)."""
        if t in self._traj_cache:
            return self._traj_cache[t]
        r = XdmfTimeSeriesReader(self.files[t])
        frames = [r.read_frame(i) for i in range(len(r))]
        r.close()
        traj = trajectory_fields(np.stack([f[0] for f in frames]),
                                 np.stack([f[1] for f in frames]),
                                 {name: np.stack([f[2][name] for f in frames])
                                  for name in frames[0][2]})
        if len(self._traj_cache) > 4:
            self._traj_cache.clear()
        self._traj_cache[t] = traj
        return traj
