"""H5 trajectory dataset -> padded MeshGraph frames.

Counterpart of graph_physics_tpu/dataset/h5_dataset.py: one h5 group per
trajectory, one dataset per field with shape [T, N, C]; the meta.json
``features`` block gives each field's dtype and shape. Trajectories are
LRU-cached; h5py is imported when a dataset is opened, and a lock
serializes reads (the loader's thread and validation both read).
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np

from graph_physics_tpu_torch.dataset.base import BaseDataset
from graph_physics_tpu_torch.dataset.preprocessing import FrameConfig


def read_meta(meta_path: str) -> Dict[str, Any]:
    """h5_dataset.py:read_meta."""
    with open(meta_path) as f:
        return json.load(f)


def import_h5py(needed_by: str):
    """h5py, or an ImportError naming what needed it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"{needed_by} needs h5py, which is not installed") from e
    return h5py


class H5Dataset(BaseDataset):
    def __init__(self, dataset_path: str, meta_path: str, frame_config: FrameConfig,
                 trajectory_cache_size: int = 8, seed: int = 0,
                 num_partitions: Optional[int] = None,
                 max_nodes_per_partition: Optional[int] = None):
        h5py = import_h5py(f"the h5 dataset {dataset_path}")
        super().__init__(frame_config, read_meta(meta_path), seed=seed,
                         num_partitions=num_partitions,
                         max_nodes_per_partition=max_nodes_per_partition)
        self.path = dataset_path
        self._h5: Optional[Any] = None
        self._h5py = h5py
        self._cache: "OrderedDict[str, Dict[str, np.ndarray]]" = OrderedDict()
        self._cache_size = trajectory_cache_size
        self._lock = threading.Lock()
        with h5py.File(dataset_path, "r") as f:
            self.traj_keys: List[str] = sorted(f.keys(), key=lambda k: (len(k), k))
            dyn = [name for name, ft in self.meta["features"].items()
                   if ft["type"] == "dynamic"]
            self._traj_len = [int(f[k][dyn[0]].shape[0]) for k in self.traj_keys]
        self._setup_index()

    @property
    def num_trajectories(self) -> int:
        return len(self.traj_keys)

    def _file(self):
        if self._h5 is None:
            self._h5 = self._h5py.File(self.path, "r")
        return self._h5

    def _trajectory(self, t: int) -> Dict[str, np.ndarray]:
        key = self.traj_keys[t]
        with self._lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                return self._cache[key]
            g = self._file()[key]
            traj = {}
            for name, ft in self.meta["features"].items():
                data = np.asarray(g[name][()], dtype=ft["dtype"])
                traj[name] = data.reshape(list(ft["shape"]))
            self._cache[key] = traj
            while len(self._cache) > self._cache_size:
                self._cache.popitem(last=False)
            return traj

    def close(self):
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None
