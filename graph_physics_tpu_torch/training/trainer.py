"""Training driver: epochs, validation rollouts, checkpoints, logging.

Counterpart of graph_physics_tpu/training/trainer.py: ``TrainerConfig``
(:47-130) with the same fields and defaults, and ``Trainer`` (:132) with
``init_or_resume`` (:370), ``fit`` (:431) and ``validate`` (:608).

  * ``fit`` shuffles each epoch with seed ``seed + epoch``, logs every
    ``log_every`` steps, runs ``steps_per_dispatch`` steps through
    training/step.make_multi_step, checkpoints when ``(epoch + 1) %
    checkpoint_every_epochs == 0`` and after the last epoch, and resumes at
    epoch ``step // steps_per_epoch``. ``stop_after_epochs`` ends it early,
    as an interrupted run would end, so a test can resume it.
  * The noise of step ``s`` is drawn from a ``torch.Generator`` seeded from
    ``(seed, s)``: a resumed run draws what an uninterrupted one would.
  * ``validate`` rolls out every validation trajectory: trajectories of one
    topology are packed ``[T, N, R, F]`` and rolled out together, at most
    ``val_device_batch`` at once, from frames cached on the host, and gives
    ``val_all_rollout_rmse`` (over every step and valid node of every
    trajectory), ``val_1step_rmse`` and ``val_loss`` (means over
    trajectories) as JAX defines them. The Transolver, which takes stacked
    batches, rolls out one trajectory at a time.
  * With ``fused`` the loader lays each topology out through
    training/fused.FusedTopologyManager, and the model runs on the layout
    of the batch it is given (``MeshGraph.layout``), which picks its
    kernels; PyTorch runs eagerly, so there is no per-topology step cache.

  * The train step's preprocess is built here, from ``noise_cfg`` and
    ``world_pos`` (training/transforms.make_device_preprocess: the noise
    over this run's ``num_steps``, then the world-position edge
    features), and ``world_pos``'s eval transform runs on each rollout
    step's graph; JAX's Trainer takes the two callables built by its CLI
    instead. A world-edge sidecar rides in every packed batch and, per
    frame, in every validation trajectory; an unpacked batch may hold
    concat-layout frames instead, stacked with their own edge arrays.
  * ``cfg.previous_data_slice`` and ``dynamic_world_edges`` reach both
    validation rollouts (training/rollout.py; trainer.py:235-248): the
    carried columns of x, the world edges found again at every step.

  * With ``save_val_visualizations`` ``validate`` renders trajectory 0's
    rollout through training/callback.PredictionVisualizer under
    ``out_dir/run_name/viz`` (trainer.py:674-696): a PNG of its first
    step and a GIF of the rollout each epoch.

  * ``loss_fn`` is a plain loss, a ``LossType`` or a ``MultiLoss``, whose
    physics terms take ``gradient_method`` (training/step.py); each logged
    step carries ``loss_term_i`` as JAX's does, and each term's value under
    ``train_<display name>`` too (``train_multiloss`` the weighted sum).

Options of later queue items raise NotImplementedError naming their
ROADMAP item: ``mtp`` (A 7), ``mesh`` (A 9).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from graph_physics_tpu_torch.core.graph import WEDGE_FIELDS, MeshGraph
from graph_physics_tpu_torch.dataset.loader import BatchLoader
from graph_physics_tpu_torch.training.callback import PredictionVisualizer, rollout_views
from graph_physics_tpu_torch.models.processors import EncodeProcessDecode, TransolverProcessor
from graph_physics_tpu_torch.models.simulator import Simulator
from graph_physics_tpu_torch.training import checkpoint as ckpt_lib
from graph_physics_tpu_torch.training import schedule as schedule_lib
from graph_physics_tpu_torch.training.logging import MetricsLogger
from graph_physics_tpu_torch.training.loss import LossType, MultiLoss
from graph_physics_tpu_torch.training.rollout import make_batched_rollout_fn, make_rollout_fn
from graph_physics_tpu_torch.training.step import (
    NoiseConfig,
    TrainState,
    init_train_state,
    make_multi_step,
    make_train_step,
)
from graph_physics_tpu_torch.training.transforms import (
    WorldPosConfig,
    make_device_preprocess,
    make_eval_transform,
)
from graph_physics_tpu_torch.utils.profiling import StepTrace


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device on a machine without one
    raises (the port never carries on on the CPU when asked for the card)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but torch.cuda.is_available() is False")
    return device


def noise_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step``'s draws, seeded from (seed, step)."""
    word = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(word) >> 1)


def loss_term_names(loss_fn):
    """``names(record) -> {train_<name>: value}``: a step record's terms
    under the loss's display names, and a MultiLoss's weighted sum as
    ``train_multiloss``; nothing for a plain loss."""
    if isinstance(loss_fn, MultiLoss):
        names = [loss.display_name for loss in loss_fn.losses]
        return lambda rec: {"train_multiloss": rec["loss"], **{
            f"train_{name}": rec[f"loss_term_{i}"] for i, name in enumerate(names)}}
    if isinstance(loss_fn, LossType):
        return lambda rec: {f"train_{loss_fn.display_name}": rec["loss"]}
    return lambda rec: {}


def steps_per_epoch(dataset, batch_size: int) -> int:
    """trainer.py:154-156 and :436-438."""
    return max((len(dataset) + batch_size - 1) // batch_size, 1)


@dataclass
class TrainerConfig:
    epochs: int = 1
    batch_size: int = 1
    learning_rate: float = 1e-3
    warmup: int = 1000
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    seed: int = 42
    out_dir: str = "runs"
    run_name: str = "run"
    checkpoint_every_epochs: int = 1
    max_val_trajectories: Optional[int] = None
    #: at most this many same-topology validation trajectories on the
    #: device at once (None: a whole group)
    val_device_batch: Optional[int] = 8
    previous_data_slice: Optional[tuple] = None
    save_val_xdmf: bool = False
    save_val_visualizations: bool = False
    use_wandb: bool = False
    log_every: int = 50
    #: trace steps 2-4 of the first epoch here (utils/profiling.StepTrace)
    profile_dir: Optional[str] = None
    accumulate_grad_batches: int = 1
    #: keep the k best checkpoints by this validation metric
    monitor_metric: Optional[str] = None
    #: trajectory-major [N, B, F] batches (training/packed.py)
    packed: bool = False
    #: packed loader: shared static leaves as [E, 1, F] views, widened on
    #: the device by the step
    broadcast_static: bool = True
    loader_workers: int = 1
    steps_per_dispatch: int = 1
    #: lay each topology out for the kernels (training/fused.py); packed only
    fused: bool = False
    #: JAX's sender-window buckets; the port's layouts have no sender
    #: windows, so only 1 is accepted
    fused_wb_buckets: int = 1
    #: transformer models: the NK layout where it is priced in (else CSR)
    fused_attn_nk: bool = True
    #: epd models: the NK layout where it is priced in (else CSR)
    fused_gn_nk: bool = True
    #: JAX's per-block-K NK buckets (ROADMAP A 8): the port takes the
    #: global-K NK layout or CSR
    fused_nk_k_buckets: int = 3


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported (ROADMAP {item})")


class Trainer:
    def __init__(self, simulator: Simulator, train_dataset, val_dataset, loss_fn,
                 cfg: TrainerConfig, gradient_method: Optional[str] = None,
                 mesh=None, run_metadata: Optional[Dict[str, Any]] = None, mtp=None,
                 dynamic_world_edges=None, noise_cfg: Optional[NoiseConfig] = None,
                 world_pos: Optional[WorldPosConfig] = None, device="cuda"):
        for value, what, item in (
                (mtp, "spatial MTP", "A 7"),
                (mesh, "a device mesh", "A 9")):
            if value is not None:
                raise _later(what, item)
        if cfg.fused_wb_buckets != 1:
            raise ValueError("fused_wb_buckets serves the TPU kernels' sender windows; the "
                             "port's layouts have none (use 1)")
        self.device = resolve_device(device)
        self.sim = simulator.to(self.device)
        self.train_ds = train_dataset
        self.val_ds = val_dataset
        self.cfg = cfg
        self.run_metadata = run_metadata or {}
        self._transolver = isinstance(simulator.model, TransolverProcessor)
        if self._transolver and cfg.packed:
            raise ValueError("the Transolver takes stacked batches: packed=False")

        self.steps_per_epoch = steps_per_epoch(train_dataset, cfg.batch_size)
        self.num_steps = self.steps_per_epoch * cfg.epochs
        self.optimizer = schedule_lib.make_optimizer(
            cfg.learning_rate, warmup=cfg.warmup, num_steps=self.num_steps,
            weight_decay=cfg.weight_decay, grad_clip=cfg.grad_clip,
            accumulate_grad_batches=cfg.accumulate_grad_batches)
        self.lr_schedule = schedule_lib.cosine_warmup_schedule(cfg.learning_rate, cfg.warmup,
                                                               self.num_steps)
        step = make_train_step(self.sim, loss_fn, make_device_preprocess(
            noise_cfg, world_pos, self.num_steps), gradient_method=gradient_method)
        self._term_names = loss_term_names(loss_fn)

        def train_step(state: TrainState, batch: MeshGraph, generator: torch.Generator):
            self._use_layout(batch)
            return step(state, batch, generator)

        self.train_step = train_step
        self.multi_step = (make_multi_step(train_step, cfg.steps_per_dispatch)
                           if cfg.steps_per_dispatch > 1 else None)
        self._fused_mgr = None
        if cfg.fused:
            if not cfg.packed:
                raise ValueError("TrainerConfig.fused requires packed=True")
            from graph_physics_tpu_torch.training.fused import FusedTopologyManager

            epd = isinstance(simulator.model, EncodeProcessDecode)
            self._fused_mgr = FusedTopologyManager(
                "epd" if epd else "transformer",
                nk=cfg.fused_gn_nk if epd else cfg.fused_attn_nk)
        self._dynamic_world = dynamic_world_edges is not None
        rollout_kw = dict(previous_data_slice=cfg.previous_data_slice,
                          frame_transform=make_eval_transform(world_pos),
                          dynamic_world_edges=dynamic_world_edges)
        self.rollout_fn = make_rollout_fn(self.sim, **rollout_kw)
        self.batched_rollout_fn = make_batched_rollout_fn(self.sim, **rollout_kw)
        self.ckpt_dir = os.path.join(cfg.out_dir, cfg.run_name, "checkpoints")
        self.manager = ckpt_lib.make_manager(self.ckpt_dir, best_metric=cfg.monitor_metric)
        #: validation trajectories stacked on the host, by topology
        self._val_groups = None
        self._logger: Optional[MetricsLogger] = None
        self.state: Optional[TrainState] = None

    @property
    def logger(self) -> MetricsLogger:
        if self._logger is None:
            cfg = self.cfg
            self._logger = MetricsLogger(
                os.path.join(cfg.out_dir, cfg.run_name), run_name=cfg.run_name,
                use_wandb=cfg.use_wandb, wandb_config=self.run_metadata,
                resume_id=self.run_metadata.get("run_id"))
            if self._logger.run_id is not None:
                self.run_metadata["run_id"] = self._logger.run_id
        return self._logger

    def _use_layout(self, graph: MeshGraph) -> None:
        """Run the model on ``graph``'s layout (None: the plain edge list)."""
        if hasattr(self.sim.model, "tiling"):
            self.sim.model.tiling = graph.layout

    def _generator(self, step: int) -> torch.Generator:
        return noise_generator(self.cfg.seed + 1, step, self.device)

    def init_or_resume(self, resume: bool = False) -> TrainState:
        """A fresh optimizer state on the simulator's weights, or, with
        ``resume``, the latest checkpoint's weights, normalizers, optimizer
        and step (its metadata joins ``run_metadata``)."""
        state = init_train_state(self.sim, self.optimizer)
        if resume:
            meta = ckpt_lib.restore_checkpoint(self.manager, self.sim, state)
            if meta:
                self.run_metadata.update(meta)
        self.state = state
        return state

    def _loader(self, epoch: int) -> BatchLoader:
        mgr = self._fused_mgr
        return BatchLoader(
            self.train_ds, self.cfg.batch_size, shuffle=True, seed=self.cfg.seed + epoch,
            packed=self.cfg.packed, frame_transform=mgr.transform_frame if mgr else None,
            packed_transform=mgr.transform_packed if mgr else None,
            workers=self.cfg.loader_workers, broadcast_static=self.cfg.broadcast_static,
            device=self.device)

    def fit(self, resume: bool = False, stop_after_epochs: Optional[int] = None) -> TrainState:
        """Train from the state (or :meth:`init_or_resume`) to ``epochs``, or
        to ``stop_after_epochs`` epochs when given."""
        cfg = self.cfg
        if self.state is None:
            self.init_or_resume(resume=resume)
        start_epoch = int(self.state.step) // self.steps_per_epoch
        end_epoch = cfg.epochs if stop_after_epochs is None else min(cfg.epochs,
                                                                     stop_after_epochs)
        for epoch in range(start_epoch, end_epoch):
            t_epoch = time.time()
            losses: List[torch.Tensor] = []
            pending: List[MeshGraph] = []
            tracer = None

            def run_single(batch):
                metrics = self.train_step(self.state, batch, self._generator(self.state.step))
                losses.append(metrics["loss"])
                step = int(self.state.step)
                if step % cfg.log_every == 0:
                    rec = {k: float(v) for k, v in metrics.items()}
                    rec.update(self._term_names(rec))
                    rec["lr"] = float(self.lr_schedule(step))
                    rec["epoch"] = epoch
                    self.logger.log(rec, step)

            def flush(force=False):
                nonlocal pending
                if self.multi_step is not None and len(pending) == cfg.steps_per_dispatch:
                    ms = self.multi_step(self.state, pending, self._generator)
                    losses.extend(ms["loss"].unbind(0))
                    pending = []
                elif force:
                    for b in pending:
                        run_single(b)
                    pending = []

            for batch in self._loader(epoch):
                if cfg.profile_dir and epoch == start_epoch and len(losses) == 1 \
                        and tracer is None:
                    tracer = StepTrace(cfg.profile_dir, self.device)
                    tracer.start()
                if self.multi_step is None:
                    run_single(batch)
                else:
                    pending.append(batch)
                    flush()
                if tracer is not None and tracer.active and len(losses) >= 4:
                    tracer.stop()
            flush(force=True)
            if tracer is not None:
                tracer.stop()

            n_batches = len(losses)
            loss_sum = sum(float(v) for v in torch.stack(losses).double().cpu()) \
                if losses else 0.0
            epoch_metrics = {"epoch": epoch, "train_loss_epoch": loss_sum / max(n_batches, 1),
                             "epoch_time_s": time.time() - t_epoch}
            val_metrics = self.validate(epoch)
            epoch_metrics.update(val_metrics)
            self.logger.log(epoch_metrics, int(self.state.step))
            print(f"epoch {epoch}: train_loss={epoch_metrics['train_loss_epoch']:.5f}"
                  + (f" val_rmse={val_metrics['val_all_rollout_rmse']:.5f}"
                     if "val_all_rollout_rmse" in val_metrics else "")
                  + f" ({epoch_metrics['epoch_time_s']:.1f}s)", flush=True)

            if (epoch + 1) % cfg.checkpoint_every_epochs == 0 or epoch == cfg.epochs - 1:
                monitor = cfg.monitor_metric
                ckpt_lib.save_checkpoint(
                    self.manager, self.sim, self.state, int(self.state.step),
                    metadata={**self.run_metadata, "epoch": epoch,
                              "run_id": self.logger.run_id},
                    metrics=({monitor: val_metrics[monitor]}
                             if monitor and monitor in val_metrics else None))
        self.manager.wait_until_finished()
        return self.state

    # ------------------------------------------------------------------
    def _val_host_groups(self, n_traj: int):
        """[(trajectory ids, [host trajectory graph ...])] by topology; with
        dynamic world edges by mesh positions too, which a packed rollout
        shares and the world edges' features read."""
        groups: Dict[tuple, list] = {}
        shared = ("senders", "receivers", "edge_mask", "node_type", "node_mask")
        if self._dynamic_world:
            shared += ("pos",)
        for t in range(n_traj):
            traj = trajectory_graph(self.val_ds, t, self._fused_mgr)
            key = (traj.x.shape, traj.y.shape,
                   None if traj.edge_attr is None else np.shape(traj.edge_attr),
                   *(np.asarray(getattr(traj, name)).tobytes() for name in shared))
            groups.setdefault(key, []).append((t, traj))
        return [([t for t, _ in entries], [g for _, g in entries])
                for entries in groups.values()]

    def validate(self, epoch: int = 0) -> Dict[str, float]:
        """Roll out every validation trajectory and aggregate as JAX's
        validate does (trainer.py:608)."""
        if self.val_ds is None:
            return {}
        n_traj = self.val_ds.num_trajectories
        if self.cfg.max_val_trajectories is not None:
            n_traj = min(n_traj, self.cfg.max_val_trajectories)
        cache_key = (id(self.val_ds), n_traj)
        if self._val_groups is None or self._val_groups[0] != cache_key:
            self._val_groups = (cache_key, self._val_host_groups(n_traj))

        sq_sum, count = 0.0, 0.0
        first_rmses: List[float] = []
        val_losses: List[float] = []
        for ts, host in self._val_groups[1]:
            chunk = 1 if self._transolver else (self.cfg.val_device_batch or len(ts))
            for s in range(0, len(ts), chunk):
                part = host[s:s + chunk]
                frames = rollout_graph(part, self.device, packed=not self._transolver)
                self._use_layout(frames)
                fn = self.rollout_fn if self._transolver else self.batched_rollout_fn
                res = fn(frames)
                sq_sum += float(res.sq_sum.sum())
                count += float(res.count.sum())
                first_rmses.extend(np.atleast_1d(res.rmse_1step.cpu().numpy()).tolist())
                val_losses.extend(np.atleast_1d(res.val_loss.mean(0).cpu().numpy()).tolist())
                part_ts = ts[s:s + chunk]
                if 0 in part_ts and (self.cfg.save_val_xdmf
                                     or self.cfg.save_val_visualizations):
                    i0 = part_ts.index(0)
                    preds, targs = ((res.predictions, res.targets) if self._transolver else
                                    (res.predictions[:, :, i0], res.targets[:, :, i0]))
                    if self.cfg.save_val_xdmf:
                        self._save_rollout_xdmf(preds.cpu().numpy(), part[i0], epoch)
                    if self.cfg.save_val_visualizations:
                        PredictionVisualizer(
                            os.path.join(self.cfg.out_dir, self.cfg.run_name, "viz"),
                            wandb_run=self.logger.wandb)(rollout_views(preds, targs), part[i0],
                                                         epoch)
                del frames, res
        return {
            "val_all_rollout_rmse": float(np.sqrt(sq_sum / max(count, 1.0))),
            "val_1step_rmse": float(np.mean(first_rmses)),
            "val_loss": float(np.mean(val_losses)),
        }

    def _save_rollout_xdmf(self, preds: np.ndarray, traj: MeshGraph, epoch: int) -> None:
        """Trajectory 0's rollout as ``meshes/epoch_<epoch>.xdmf``
        (trainer.py:_save_rollout_xdmf)."""
        path = os.path.join(self.cfg.out_dir, self.cfg.run_name, "meshes",
                            f"epoch_{epoch}.xdmf")
        write_rollout_xdmf(path, preds, traj)


def trajectory_graph(dataset, t: int, manager=None) -> MeshGraph:
    """Trajectory ``t``'s rollout frames (laid out by ``manager``, a
    FusedTopologyManager, when given) as one host graph: x, y [T, N, F],
    time [T], a world-edge sidecar's leaves [T, W, ...] (each frame's
    own), the static leaves of frame 0. Frames whose edge arrays differ
    (concat-layout world edges) raise: a rollout takes world edges in a
    sidecar, or, found again at every step, in a concat frame's reserved
    tail, which is the same in every frame."""
    frames = dataset.trajectory_frames(t)
    if manager is not None:
        frames = [manager.transform_frame(f) for f in frames]
    return stack_trajectory(frames, f"trajectory {t}")


def stack_trajectory(frames: List[MeshGraph], label: str = "trajectory") -> MeshGraph:
    """One trajectory's host frames as :func:`trajectory_graph` gives them."""
    for field in ("senders", "receivers", "edge_mask"):
        ref = np.asarray(getattr(frames[0], field))
        if any(not np.array_equal(np.asarray(getattr(f, field)), ref) for f in frames[1:]):
            raise ValueError(f"{label}: the frames' {field} differ; build rollout frames "
                             "with world edges in the sidecar layout")

    def per_frame(name):
        if getattr(frames[0], name) is None:
            return None
        return np.stack([np.asarray(getattr(f, name)) for f in frames])

    return frames[0].replace(
        x=per_frame("x"), y=per_frame("y"),
        time=np.asarray([np.asarray(f.time) for f in frames], np.float32),
        prev=None, next_data=None, deselected=None,
        **{name: per_frame(name) for name in WEDGE_FIELDS})


def rollout_graph(trajs: List[MeshGraph], device, packed: bool = True) -> MeshGraph:
    """R host trajectory graphs of one topology as one device graph for the
    rollout: packed, x [T, N, R, F], edge_attr [E, R, Fe] and a sidecar's
    leaves [T, W, R, ...]; or, unpacked, the first one alone (x [T, N, F])."""
    g0 = trajs[0]
    if not packed:
        return MeshGraph.from_numpy(g0.replace(time=None), device)

    def per_trajectory(name, axis):
        if getattr(g0, name) is None:
            return None
        return np.stack([np.asarray(getattr(g, name)) for g in trajs], axis=axis)

    return MeshGraph.from_numpy(g0.replace(
        x=per_trajectory("x", 2), y=per_trajectory("y", 2),
        edge_attr=per_trajectory("edge_attr", 1), time=None,
        **{name: per_trajectory(name, 2) for name in WEDGE_FIELDS}), device)


def write_rollout_xdmf(path: str, preds: np.ndarray, traj: MeshGraph) -> str:
    """Write a rollout (``preds`` [T, N', F]) of the host trajectory graph
    ``traj`` (x, y [T, N', F], static leaves of frame 0) as an XDMF time
    series of ``prediction`` and ``target`` on its valid nodes and cells."""
    from graph_physics_tpu_torch.utils.xdmf import XdmfTimeSeriesWriter

    w = XdmfTimeSeriesWriter(path)
    n = int(traj.n_node)
    c = int(np.sum(np.asarray(traj.face_mask))) if traj.face_mask is not None else None
    pos = np.asarray(traj.pos)[:n]
    cells = np.asarray(traj.faces)[:c]
    for i in range(preds.shape[0]):
        w.append(pos, cells, {"prediction": preds[i, :n], "target": np.asarray(traj.y[i])[:n]},
                 float(traj.time[i]) if traj.time is not None else float(i))
    return w.path
