"""Host-side frame -> padded MeshGraph pipeline (numpy; runs in the loader).

Counterpart of graph_physics_tpu/dataset/preprocessing.py, numpy only:

  frame fields -> node features x = [dynamic fields..., node_type, time]
  -> extra_node_features hook
  -> [world] obstacle-displacement columns after the world positions
  -> faces -> edges (+ k-hop, cached per trajectory)
  -> [world, concat] radius world edges appended to the mesh edges
  -> random-edge augmentation
  -> node masking -> ``deselected``
  -> pad to shape buckets, edge features [Δpos, ‖Δpos‖]
  -> [world, sidecar] radius world edges as the per-sample sidecar (``wedge_*``).

Each function names its source. World edges come in two layouts
(``WorldConfig.sidecar``). The concat layout, JAX's default, appends each
frame's budgeted world edges to its mesh edges, so the edge arrays change
from frame to frame (an unpacked batch stacks them per sample). The
sidecar layout, what JAX's CLI takes with ``--packed``, keeps the static
mesh in the shared edge arrays, and each frame's world edges ride beside
them, padded to ``edge_budget`` slots. A sub-mesh part (``part_ids``)
is sliced out of the frame last, after the augmentations; its frames
carry no cells, and world edges come to it in the concat layout only. The
per-step value
transforms (noise, the world-position edge features) run on the device
(training/noise.py, training/transforms.py).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from graph_physics_tpu_torch import native
from graph_physics_tpu_torch.core import mesh as mesh_lib
from graph_physics_tpu_torch.core import padding
from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.core.nodetype import NodeType
from graph_physics_tpu_torch.dataset.partition import extract_subgraph

# Fields that never become node features.
STRUCTURAL_FIELDS = ("cells", "mesh_pos", "node_type")

@dataclass(frozen=True)
class WorldConfig:
    """World-edge parameters (preprocessing.py:WorldConfig): the world
    positions' columns of x, the radius of the pairs, the per-frame edge
    budget, and the layout: ``sidecar`` (per-sample arrays beside the
    static mesh edges) or the concat layout (the world edges appended to
    the mesh edges). Discovery runs on the host from the un-noised
    positions, as JAX's does."""

    world_pos_index_start: int
    world_pos_index_end: int
    node_type_index: int  # index after the displacement columns are inserted
    radius: float = 0.03
    edge_budget: int = 1024
    sidecar: bool = False


@dataclass(frozen=True)
class FrameConfig:
    """preprocessing.py:FrameConfig."""

    targets: Tuple[str, ...]
    khop: int = 1
    world: Optional[WorldConfig] = None
    new_edges_ratio: float = 0.0
    masking_ratio: float = 0.0
    use_previous_data: bool = False
    add_edge_features: bool = True
    extra_node_features: Optional[Callable] = None
    extra_edge_features: Optional[Callable] = None
    noise_shift_ratio: float = 0.0  # reserved


@dataclass
class FrameContext:
    """Everything a feature builder may need (preprocessing.py:FrameContext)."""

    pos: np.ndarray
    cells: np.ndarray
    point_data: Dict[str, np.ndarray]  # current frame fields (order preserved)
    node_type: np.ndarray
    time: float
    target: Optional[Dict[str, np.ndarray]]  # target fields at t+1
    next_data: Optional[Dict[str, np.ndarray]]  # dynamic non-target fields at t+1
    previous_data: Optional[Dict[str, np.ndarray]]  # dynamic fields at t-1
    x: Optional[np.ndarray] = None  # assembled features (a builder may replace them)
    phi: Optional[np.ndarray] = None  # per-node gate scalar (builders may set it)


def extract_frame(traj: Dict[str, np.ndarray], frame: int, meta: Dict[str, Any],
                  targets: Tuple[str, ...], with_target: bool = True,
                  with_previous: bool = False) -> FrameContext:
    """One frame's arrays of a trajectory dict (preprocessing.py:
    extract_frame): static fields from frame 0 when stored once, node_type
    from frame 0, time = frame * dt."""
    dynamic_keys = [k for k in traj.keys() if k not in STRUCTURAL_FIELDS]
    point_data = {k: traj[k][frame] for k in dynamic_keys}
    node_type = np.asarray(traj["node_type"][0]).reshape(-1)
    pos = traj["mesh_pos"][frame] if traj["mesh_pos"].ndim > 2 else traj["mesh_pos"]
    cells = traj["cells"][frame] if traj["cells"].ndim > 2 else traj["cells"]

    target = None
    next_data = None
    if with_target and frame + 1 < len(traj[dynamic_keys[0]]):
        target = {k: traj[k][frame + 1] for k in targets}
        next_data = {k: traj[k][frame + 1] for k in dynamic_keys if k not in targets}
    previous = None
    if with_previous and frame > 0:
        previous = {k: traj[k][frame - 1] for k in dynamic_keys}

    dt = float(meta.get("dt", 1.0)) or 1.0
    return FrameContext(
        pos=np.asarray(pos, np.float32),
        cells=np.asarray(cells, np.int32),
        point_data=point_data,
        node_type=node_type.astype(np.int32),
        time=frame * dt,
        target=target,
        next_data=next_data,
        previous_data=previous,
    )


def assemble_x(ctx: FrameContext) -> np.ndarray:
    """x = [dynamic fields (dict order), node_type, time]
    (preprocessing.py:assemble_x)."""
    n = len(ctx.pos)
    cols = [np.asarray(v, np.float32).reshape(n, -1) for v in ctx.point_data.values()]
    cols.append(ctx.node_type.astype(np.float32).reshape(n, 1))
    cols.append(np.full((n, 1), ctx.time, np.float32))
    return np.concatenate(cols, axis=-1)


def _stack_fields(d: Dict[str, np.ndarray], n: int) -> np.ndarray:
    """preprocessing.py:_stack_fields."""
    return np.concatenate([np.asarray(v, np.float32).reshape(n, -1) for v in d.values()],
                          axis=-1)


def insert_obstacle_displacement(x: np.ndarray, y: np.ndarray, node_type: np.ndarray,
                                 world: WorldConfig) -> np.ndarray:
    """Insert the [target world_pos - world_pos] columns after the world
    positions; rows that are not OBSTACLE get the obstacles' mean
    displacement (preprocessing.py:insert_obstacle_displacement :155)."""
    ws, we = world.world_pos_index_start, world.world_pos_index_end
    wp = x[:, ws:we]
    disp = y[:, ws:we] - wp
    is_obs = node_type == NodeType.OBSTACLE
    if is_obs.any():
        mean_disp = disp[is_obs].mean(axis=0)
    else:
        mean_disp = np.zeros(we - ws, np.float32)
    disp = np.where(is_obs[:, None], disp, mean_disp[None, :])
    return np.concatenate([x[:, :we], disp, x[:, we:]], axis=-1).astype(np.float32)


def random_extra_edges(edge_index: np.ndarray, num_nodes: int, ratio: float,
                       rng: np.random.Generator) -> np.ndarray:
    """Add ``ratio * E`` uniformly random directed edges
    (preprocessing.py:random_extra_edges)."""
    e = edge_index.shape[1]
    k = int(round(e * ratio))
    if k <= 0:
        return edge_index
    src = rng.integers(0, num_nodes, size=k)
    dst = rng.integers(0, num_nodes, size=k)
    keep = src != dst
    extra = np.stack([src[keep], dst[keep]])
    return np.concatenate([edge_index, extra], axis=1).astype(np.int32)


def masked_node_selection(num_nodes: int, ratio: float,
                          rng: np.random.Generator) -> Optional[np.ndarray]:
    """``ratio * N`` node ids excluded from the loss
    (preprocessing.py:masked_node_selection)."""
    if ratio <= 0:
        return None
    k = int(num_nodes * ratio)
    perm = rng.permutation(num_nodes)
    sel = np.zeros(num_nodes, dtype=bool)
    sel[perm[:k]] = True
    return sel


def compute_min_distance_to_type(pos: np.ndarray, node_type: np.ndarray,
                                 target_type: int) -> np.ndarray:
    """Min distance from each node to any node of ``target_type``
    (preprocessing.py:compute_min_distance_to_type)."""
    mask = np.asarray(node_type).reshape(-1) == int(target_type)
    if not mask.any():
        return np.full(len(pos), np.inf, np.float32)
    d = np.linalg.norm(pos[:, None, :] - pos[mask][None, :, :], axis=-1)
    return d.min(axis=1).astype(np.float32)


def random_3d_rotation_matrix(rng: np.random.Generator) -> np.ndarray:
    """Random Euler rotation, yaw/pitch/roll uniform in [-180°, 180°]
    (preprocessing.py:random_3d_rotation_matrix)."""
    a, b, g = rng.uniform(-np.pi, np.pi, size=3)
    ca, sa = np.cos(a), np.sin(a)
    cb, sb = np.cos(b), np.sin(b)
    cg, sg = np.cos(g), np.sin(g)
    return np.array(
        [
            [ca * cb, ca * sb * sg + sa * cg, -ca * sb * cg + sa * sg],
            [-sa * cb, -sa * sb * sg + ca * cg, sa * sb * cg + ca * sg],
            [sb, -cb * sg, cb * cg],
        ],
        dtype=np.float32,
    )


def random_3d_rotate(pos: np.ndarray, x: np.ndarray, y: Optional[np.ndarray],
                     feature_indices, rng: np.random.Generator):
    """Rotate pos, the listed x column triplets and y[:, :3] by one random
    rotation; y is replaced by its rotated first 3 columns
    (preprocessing.py:random_3d_rotate)."""
    for s, e in feature_indices or []:
        if e - s != 3:
            raise ValueError(f"feature range must span 3 columns, got {s}-{e}")
    r = random_3d_rotation_matrix(rng)
    pos = (pos @ r).astype(np.float32)
    x = np.array(x, copy=True)
    for s, e in feature_indices or []:
        x[:, s:e] = x[:, s:e] @ r
    if y is not None:
        y = (y[:, 0:3] @ r).astype(np.float32)
    return pos, x, y


class FrameBuilder:
    """Caches k-hop edges and each trajectory's static frame skeleton
    (preprocessing.py:FrameBuilder)."""

    def __init__(self, cfg: FrameConfig, meta: Dict[str, Any]):
        self.cfg = cfg
        self.meta = meta
        self._khop_cache: Dict[Any, np.ndarray] = {}
        #: per-trajectory static frame skeleton (topology, positions, edge
        #: features, masks, padding), LRU-bounded: frames built from it
        #: share those leaves as the same numpy objects
        self._skel_cache: "OrderedDict[Any, MeshGraph]" = OrderedDict()
        self._skel_cache_size = 64
        #: per-trajectory sorted keys of the mesh edges, which the world
        #: edges of every frame leave out
        self._wedge_exclude_cache: Dict[Any, np.ndarray] = {}

    def mesh_edges(self, cache_key, cells: np.ndarray, num_nodes: int) -> np.ndarray:
        """faces -> edges (+ k-hop), cached per trajectory
        (preprocessing.py:FrameBuilder.mesh_edges)."""
        if cache_key in self._khop_cache:
            return self._khop_cache[cache_key]
        ei = native.faces_to_edges(cells, num_nodes)
        if self.cfg.khop > 1:
            ei = native.k_hop(ei, num_nodes, self.cfg.khop)
        self._khop_cache[cache_key] = ei
        return ei

    def build(self, traj: Dict[str, np.ndarray], frame: int, traj_index: int = 0,
              rng: Optional[np.random.Generator] = None, n_pad: Optional[int] = None,
              e_pad: Optional[int] = None, c_pad: Optional[int] = None, train: bool = True,
              cache_key: Optional[Any] = None,
              part_ids: Optional[np.ndarray] = None) -> MeshGraph:
        """One padded frame (preprocessing.py:FrameBuilder.build :299); the
        static-skeleton fast path rebuilds only the dynamic leaves, and the
        world-edge sidecar. Concat-layout world edges change the edge
        arrays every frame, so they take the full path, as a sub-mesh part
        (``part_ids``, :329-336, :432-443) does: the part's slice of the
        augmented frame, its edges relabelled by
        dataset/partition.extract_subgraph, no cells."""
        cfg = self.cfg
        ctx = extract_frame(traj, frame, self.meta, cfg.targets, with_target=True,
                            with_previous=cfg.use_previous_data)
        n = len(ctx.pos)
        world = cfg.world is not None
        sidecar = world and cfg.world.sidecar
        key = cache_key if cache_key is not None else traj_index
        if sidecar and part_ids is not None:
            raise ValueError("world sidecar mode is incompatible with sub-mesh partitions "
                             "(use the concat world layout)")

        skel_ok = (cfg.new_edges_ratio == 0 and cfg.extra_node_features is None
                   and cfg.extra_edge_features is None and (not world or sidecar)
                   and part_ids is None)
        skel_key = ((cache_key if cache_key is not None else traj_index, n_pad, e_pad, c_pad)
                    if skel_ok else None)
        skel = self._skel_cache.get(skel_key) if skel_ok else None
        if skel is not None:
            self._skel_cache.move_to_end(skel_key)
            ctx.x = assemble_x(ctx)
            np_ = skel.x.shape[0]

            def pad(a):
                return None if a is None else padding.pad_axis(np.asarray(a, np.float32), np_)

            deselected = None
            if train and cfg.masking_ratio > 0 and rng is not None:
                deselected = padding.pad_axis(masked_node_selection(n, cfg.masking_ratio, rng),
                                              np_, fill=False)
            y = _stack_fields(ctx.target, n) if ctx.target else None
            x, rep = ctx.x, {}
            if world:
                if y is not None:
                    x = insert_obstacle_displacement(x, y, ctx.node_type, cfg.world)
                rep = self._world_sidecar_fields(x, ctx.node_type, ctx.pos,
                                                 self.mesh_edges(key, ctx.cells, n), np_, key)
            return skel.replace(
                x=pad(x),
                y=pad(y),
                prev=pad(_stack_fields(ctx.previous_data, n) if ctx.previous_data else None),
                next_data=pad(_stack_fields(ctx.next_data, n) if ctx.next_data else None),
                time=np.float32(ctx.time),
                deselected=deselected,
                **rep,
            )

        if cfg.extra_node_features is not None:
            ctx = cfg.extra_node_features(ctx)
        if ctx.x is None:
            ctx.x = assemble_x(ctx)
        x = ctx.x
        y = _stack_fields(ctx.target, n) if ctx.target is not None else None
        next_data = _stack_fields(ctx.next_data, n) if ctx.next_data else None
        prev = _stack_fields(ctx.previous_data, n) if ctx.previous_data else None
        if world and y is not None:
            x = insert_obstacle_displacement(x, y, ctx.node_type, cfg.world)

        ei = mesh_ei = self.mesh_edges(key, ctx.cells, n)
        if world and not sidecar:
            # the budgeted pairs after the mesh edges (preprocessing.py:411-420):
            # both directions of a pair kept or dropped together
            ws, we = cfg.world.world_pos_index_start, cfg.world.world_pos_index_end
            wedges = mesh_lib.radius_world_edges(x[:, ws:we], ctx.node_type, cfg.world.radius,
                                                 exclude_edges=ei)
            wedges = mesh_lib.budget_world_pairs(wedges, x[:, ws:we], cfg.world.edge_budget)
            ei = np.concatenate([ei, wedges], axis=1)
        if train and cfg.new_edges_ratio > 0 and rng is not None:
            ei = random_extra_edges(ei, n, cfg.new_edges_ratio, rng)

        deselected = None
        if train and cfg.masking_ratio > 0 and rng is not None:
            deselected = masked_node_selection(n, cfg.masking_ratio, rng)

        pos, node_type, faces, phi = ctx.pos, ctx.node_type, ctx.cells, ctx.phi
        if part_ids is not None:
            ei, _ = extract_subgraph(part_ids, ei, n)

            def sel(a):
                return None if a is None else a[part_ids]

            x, pos, node_type = x[part_ids], pos[part_ids], node_type[part_ids]
            y, prev, next_data = sel(y), sel(prev), sel(next_data)
            deselected, phi = sel(deselected), sel(phi)
            faces = None  # the cells are not sliced (nor are they in the reference)

        g = mesh_lib.build_mesh_graph(
            x, pos, node_type, ei, y=y, prev=prev, next_data=next_data,
            faces=faces, n_pad=n_pad, e_pad=e_pad, c_pad=c_pad,
            with_edge_features=cfg.add_edge_features, traj_index=traj_index, time=ctx.time)
        if sidecar:
            g = g.replace(**self._world_sidecar_fields(x, ctx.node_type, ctx.pos, mesh_ei,
                                                       g.x.shape[0], key))
        if cfg.extra_edge_features is not None:
            g = cfg.extra_edge_features(g)
        if deselected is not None:
            g = g.replace(deselected=padding.pad_axis(deselected, g.x.shape[0], fill=False))
        if phi is not None:
            g = g.replace(phi=padding.pad_axis(np.asarray(phi, np.float32).reshape(-1),
                                               g.x.shape[0], fill=0.0))
        if skel_key is not None:
            self._skel_cache[skel_key] = g
            while len(self._skel_cache) > self._skel_cache_size:
                self._skel_cache.popitem(last=False)
        return g

    def _world_sidecar_fields(self, x: np.ndarray, node_type: np.ndarray, pos: np.ndarray,
                              mesh_ei: np.ndarray, n_pad: int,
                              cache_key: Optional[Any] = None) -> Dict[str, np.ndarray]:
        """One frame's world edges as the sidecar's arrays of ``edge_budget``
        slots (preprocessing.py:FrameBuilder._world_sidecar_fields :487):
        discovered from x's world positions, less the mesh edges (their
        keys cached per trajectory), budgeted rank-fairly; the unused slots
        have sender 0, receiver ``n_pad`` - 1 and mask False. ``wedge_attr``
        holds [Δpos, ‖Δpos‖] of the mesh positions, as the mesh edges'
        features, when the config adds edge features."""
        cfg = self.cfg
        ws, we = cfg.world.world_pos_index_start, cfg.world.world_pos_index_end
        ex_keys = None
        if cache_key is not None:
            ck = (cache_key, int(mesh_ei.shape[1]))
            ex_keys = self._wedge_exclude_cache.get(ck)
            if ex_keys is None:
                ex_keys = mesh_lib.world_edge_exclude_keys(mesh_ei, len(x))
                if len(self._wedge_exclude_cache) > 256:
                    self._wedge_exclude_cache.clear()
                self._wedge_exclude_cache[ck] = ex_keys
        wedges = mesh_lib.radius_world_edges(x[:, ws:we], node_type, cfg.world.radius,
                                             exclude_edges=mesh_ei, exclude_keys=ex_keys)
        wedges = mesh_lib.budget_world_pairs(wedges, x[:, ws:we], cfg.world.edge_budget)
        budget = cfg.world.edge_budget
        k = wedges.shape[1]
        send = np.zeros(budget, np.int32)
        recv = np.full(budget, n_pad - 1, np.int32)
        mask = np.zeros(budget, bool)
        send[:k], recv[:k], mask[:k] = wedges[0], wedges[1], True
        out = {"wedge_senders": send, "wedge_receivers": recv, "wedge_mask": mask}
        if cfg.add_edge_features:
            attr = np.zeros((budget, pos.shape[-1] + 1), np.float32)
            if k:
                attr[:k] = mesh_lib.edge_features(np.asarray(pos), wedges[0], wedges[1])
            out["wedge_attr"] = attr
        return out

    def build_packed(self, traj: Dict[str, np.ndarray], frames: np.ndarray,
                     traj_index: int = 0, n_pad: Optional[int] = None,
                     e_pad: Optional[int] = None, c_pad: Optional[int] = None,
                     train: bool = True, cache_key: Optional[Any] = None
                     ) -> Optional[MeshGraph]:
        """All B frames of one batch -> [N, B, F] dynamic leaves, directly
        (preprocessing.py:FrameBuilder.build_packed :545): equal to
        ``pack_frames([build(f) for f in frames])`` but half-packed (the
        static-slot leaves edge_attr, phi stay single; training/packed.
        finalize_packed adds their batch axis). None outside the fast
        regime (no skeleton yet, frame-dependent edges or features,
        masking, a frame without a target, frame 0 with previous data, world
        edges)."""
        cfg = self.cfg
        if (cfg.world is not None or cfg.new_edges_ratio != 0 or cfg.extra_node_features is not None
                or cfg.extra_edge_features is not None
                or (train and cfg.masking_ratio > 0)):
            return None
        skel_key = (cache_key if cache_key is not None else traj_index, n_pad, e_pad, c_pad)
        skel = self._skel_cache.get(skel_key)
        if skel is None:
            return None  # the first batch builds the skeleton frame by frame
        self._skel_cache.move_to_end(skel_key)

        frames = np.asarray(frames, np.int64)
        dynamic_keys = [k for k in traj.keys() if k not in STRUCTURAL_FIELDS]
        t_len = len(traj[dynamic_keys[0]])
        if (frames + 1 >= t_len).any():
            return None
        if cfg.use_previous_data and (frames == 0).any():
            return None
        b = len(frames)
        np_rows = skel.x.shape[0]
        n = traj[dynamic_keys[0]].shape[1]
        dt = float(self.meta.get("dt", 1.0)) or 1.0
        times = (frames * dt).astype(np.float32)

        def packed_concat(keys, frame_ids, extra_cols=0):
            widths = [int(np.prod(traj[k].shape[2:], dtype=np.int64)) or 1 for k in keys]
            out = np.zeros((np_rows, b, sum(widths) + extra_cols), np.float32)
            col = 0
            for k, w in zip(keys, widths):
                a = np.ascontiguousarray(traj[k][frame_ids], np.float32).reshape(b, n, w)
                native.pack_block(a, out, col)
                col += w
            return out, col

        x, col = packed_concat(dynamic_keys, frames, extra_cols=2)
        x[:n, :, col] = np.asarray(traj["node_type"][0], np.float32).reshape(-1)[:, None]
        x[:n, :, col + 1] = times[None, :]
        if x.shape[-1] != skel.x.shape[-1]:
            raise AssertionError("x column layout drifted")
        y, _ = packed_concat(list(cfg.targets), frames + 1)
        nt_keys = [k for k in dynamic_keys if k not in cfg.targets]
        next_data = packed_concat(nt_keys, frames + 1)[0] if nt_keys else None
        prev = packed_concat(dynamic_keys, frames - 1)[0] if cfg.use_previous_data else None
        return skel.replace(x=x, y=y, prev=prev, next_data=next_data, time=times,
                            deselected=None)

    def edge_budget_for(self, mesh_edge_count: int) -> int:
        """Static edge bucket: mesh edges, the concat layout's world budget
        and random-edge headroom (preprocessing.py:FrameBuilder.
        edge_budget_for :652); the sidecar's world edges live in their own
        arrays."""
        extra = 0
        if self.cfg.world is not None and not self.cfg.world.sidecar:
            extra += self.cfg.world.edge_budget
        if self.cfg.new_edges_ratio > 0:
            extra += int(mesh_edge_count * self.cfg.new_edges_ratio) + 1
        return padding.bucket_size(mesh_edge_count + extra)
