"""BaseDataset: index math, bucket pinning and frame access.

Counterpart of graph_physics_tpu/dataset/base.py:BaseDataset, numpy only:
a flat sample index maps to (trajectory, frame, partition); every frame of
a trajectory is padded to the trajectory's pinned (n_pad, e_pad, c_pad)
bucket. Subclasses provide ``_trajectory(t) -> field dict``,
``num_trajectories`` and ``_traj_len``. With sub-mesh partitions
(``num_partitions`` or ``max_nodes_per_partition``, base.py:35-37) each
(frame, part) is a sample: a trajectory's parts come from
dataset/partition.PartitionCache, and its bucket is pinned by its largest
part (its node count, and the edge budget of its edge count; no cells
bucket: a part's frames carry no cells).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from graph_physics_tpu_torch.core import padding
from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.dataset.partition import PartitionCache
from graph_physics_tpu_torch.dataset.preprocessing import FrameBuilder, FrameConfig


class BaseDataset:
    def __init__(self, frame_config: FrameConfig, meta: Dict[str, Any], seed: int = 0,
                 num_partitions: Optional[int] = None,
                 max_nodes_per_partition: Optional[int] = None):
        self.meta = meta
        self.cfg = frame_config
        self.builder = FrameBuilder(frame_config, meta)
        self._rng = np.random.default_rng(seed)
        self._partitions: Optional[PartitionCache] = None
        if num_partitions or max_nodes_per_partition:
            self._partitions = PartitionCache(num_partitions, max_nodes_per_partition)
        # subclasses fill these in _setup_index()
        self._traj_len: List[int] = []
        self._traj_parts: List[int] = []
        self._n_pad: List[int] = []
        self._e_pad: List[int] = []
        self._c_pad: List[Optional[int]] = []
        self._start = 1 if frame_config.use_previous_data else 0

    # subclass interface
    def _trajectory(self, t: int) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    @property
    def num_trajectories(self) -> int:
        raise NotImplementedError

    def _setup_index(self) -> None:
        """Pin each trajectory's buckets and build the index map; call at
        the end of a subclass's __init__ (base.py:_setup_index)."""
        self._n_pad, self._e_pad, self._c_pad, self._traj_parts = [], [], [], []
        for t in range(self.num_trajectories):
            pos, cells, ei = self._mesh(t)
            if self._partitions is not None:
                parts, subs = self._partitions.parts_for(t, pos, ei)
                self._traj_parts.append(len(parts))
                self._n_pad.append(padding.bucket_size(max(len(p) for p in parts)))
                self._e_pad.append(self.builder.edge_budget_for(
                    max(sub[0].shape[1] for sub in subs)))
                self._c_pad.append(None)
            else:
                self._traj_parts.append(1)
                self._n_pad.append(padding.bucket_size(pos.shape[0]))
                self._e_pad.append(self.builder.edge_budget_for(ei.shape[1]))
                self._c_pad.append(padding.bucket_size(len(cells)))
        self._samples = [max(tl - 1 - self._start, 0) * p
                         for tl, p in zip(self._traj_len, self._traj_parts)]
        self._cum = np.cumsum([0] + self._samples)

    def _mesh(self, t: int):
        """(positions, cells, mesh edges) of trajectory ``t``'s first frame."""
        traj = self._trajectory(t)
        pos = traj["mesh_pos"][0] if traj["mesh_pos"].ndim > 2 else traj["mesh_pos"]
        cells = traj["cells"][0] if traj["cells"].ndim > 2 else traj["cells"]
        return pos, cells, self.builder.mesh_edges(t, cells, pos.shape[0])

    def part_ids(self, t: int, part: int) -> Optional[np.ndarray]:
        """The node ids of trajectory ``t``'s part ``part``, None without
        partitions (base.py:get_frame :113-135)."""
        if self._partitions is None:
            return None
        return self._partitions.parts_for(t, *self._mesh(t)[::2])[0][part]

    def __len__(self) -> int:
        return int(self._cum[-1])

    def indices_for(self, idx: int) -> Tuple[int, int, int]:
        """flat idx -> (trajectory, frame, partition)."""
        t = int(np.searchsorted(self._cum, idx, side="right") - 1)
        rem = int(idx - self._cum[t])
        parts = self._traj_parts[t]
        return t, rem // parts + self._start, rem % parts

    def bucket_of(self, idx: int) -> Tuple[int, int, Optional[int]]:
        """The static-shape bucket of a sample, cells bucket included: the
        loader batches only within one bucket."""
        t, _, _ = self.indices_for(idx)
        return self._n_pad[t], self._e_pad[t], self._c_pad[t]

    def __getitem__(self, idx: int) -> MeshGraph:
        t, frame, part = self.indices_for(idx)
        return self.get_frame(t, frame, part=part, train=True)

    def get_frame(self, t: int, frame: int, part: int = 0, train: bool = True) -> MeshGraph:
        """Frame ``frame`` of trajectory ``t``, sliced to its part ``part``
        under partitions (base.py:get_frame)."""
        return self.builder.build(
            self._trajectory(t), frame, traj_index=t, rng=self._rng if train else None,
            n_pad=self._n_pad[t], e_pad=self._e_pad[t], c_pad=self._c_pad[t], train=train,
            cache_key=t, part_ids=self.part_ids(t, part))

    def get_frames_packed(self, idxs, train: bool = True) -> Optional[MeshGraph]:
        """A whole same-trajectory batch as one half-packed graph
        (base.py:get_frames_packed :137), or None outside the vectorized
        regime (sub-mesh partitions among them): the caller then builds
        frame by frame."""
        if self._partitions is not None:
            return None
        tfp = [self.indices_for(int(i)) for i in idxs]
        t0 = tfp[0][0]
        if any(t != t0 or p != 0 for t, _, p in tfp):
            return None
        return self.builder.build_packed(
            self._trajectory(t0), np.asarray([f for _, f, _ in tfp], np.int64), traj_index=t0,
            n_pad=self._n_pad[t0], e_pad=self._e_pad[t0], c_pad=self._c_pad[t0], train=train,
            cache_key=t0)

    def trajectory_frames(self, t: int, part: int = 0) -> List[MeshGraph]:
        """All rollout frames of trajectory ``t`` (no augmentation)."""
        return [self.get_frame(t, f, part=part, train=False)
                for f in range(self._start, self._traj_len[t] - 1)]

