"""Validation visualizations: frame screenshots and a rollout animation.

Counterpart of graph_physics_tpu/training/callback.py (:19-158):
``render_field_comparison`` (prediction, target and absolute error on the
mesh, one PNG), ``render_rollout_animation`` (prediction beside target
over the rollout, a GIF through Pillow) and ``PredictionVisualizer``,
which the Trainer's ``validate`` calls on trajectory 0's rollout with
``save_val_visualizations``: ``epoch_{e}_frame_{i}.png`` for each chosen
step i and ``epoch_{e}_rollout.gif``, logged to wandb when a run is
attached. matplotlib is imported inside each call: where it is missing,
the call raises an ImportError that names it.
"""

from __future__ import annotations

import os
from types import SimpleNamespace
from typing import List, Optional, Sequence

import numpy as np


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("save_val_visualizations renders with matplotlib, which is not "
                          "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _tri(pos: np.ndarray, faces: Optional[np.ndarray]):
    import matplotlib.tri as mtri

    if faces is not None and faces.shape[1] == 3:
        return mtri.Triangulation(pos[:, 0], pos[:, 1], faces)
    return mtri.Triangulation(pos[:, 0], pos[:, 1])


def render_field_comparison(pos: np.ndarray, faces: Optional[np.ndarray],
                            predicted: np.ndarray, target: np.ndarray, path: str,
                            title: str = "", component: int = 0) -> str:
    """Prediction, target and absolute error of one field component side
    by side on the mesh, as a PNG (callback.py:render_field_comparison)."""
    plt = _pyplot()
    tri = _tri(pos, faces)
    p = predicted[:, component] if predicted.ndim > 1 else predicted
    t = target[:, component] if target.ndim > 1 else target
    vmin, vmax = float(min(p.min(), t.min())), float(max(p.max(), t.max()))
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    for ax, (data, name) in zip(axes, [(p, "prediction"), (t, "target"),
                                       (np.abs(p - t), "abs error")]):
        kwargs = {} if name == "abs error" else {"vmin": vmin, "vmax": vmax}
        m = ax.tripcolor(tri, data, shading="gouraud", **kwargs)
        ax.set_title(f"{title} {name}")
        ax.set_aspect("equal")
        fig.colorbar(m, ax=ax, shrink=0.8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def render_rollout_animation(pos: np.ndarray, faces: Optional[np.ndarray],
                             predictions: np.ndarray, targets: np.ndarray, path: str,
                             component: int = 0, fps: int = 10, max_frames: int = 120) -> str:
    """Prediction beside target over the rollout ([T, N, F] each), at most
    ``max_frames`` steps evenly spaced, as a GIF
    (callback.py:render_rollout_animation)."""
    plt = _pyplot()
    import matplotlib.animation as manim

    tri = _tri(pos, faces)
    t_idx = np.linspace(0, len(predictions) - 1,
                        min(len(predictions), max_frames)).astype(int)
    vmin = float(targets[..., component].min())
    vmax = float(targets[..., component].max())
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    for ax in (ax1, ax2):
        ax.set_aspect("equal")
    m1 = ax1.tripcolor(tri, predictions[0][:, component], shading="gouraud", vmin=vmin,
                       vmax=vmax)
    m2 = ax2.tripcolor(tri, targets[0][:, component], shading="gouraud", vmin=vmin, vmax=vmax)
    ax1.set_title("prediction")
    ax2.set_title("target")

    def update(i):
        m1.set_array(predictions[t_idx[i]][:, component])
        m2.set_array(targets[t_idx[i]][:, component])
        return m1, m2

    anim = manim.FuncAnimation(fig, update, frames=len(t_idx), blit=False)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    anim.save(path, writer=manim.PillowWriter(fps=fps))
    plt.close(fig)
    return path


def rollout_views(predictions, targets) -> SimpleNamespace:
    """A rollout's predictions and targets ([T, N, F] tensors or arrays) as
    numpy, the ``rollout_result`` :class:`PredictionVisualizer` takes."""
    def host(a):
        return a.detach().float().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)

    return SimpleNamespace(predictions=host(predictions), targets=host(targets))


class PredictionVisualizer:
    """Validation's end-of-epoch hook (callback.py:PredictionVisualizer):
    screenshots of the rollout steps ``indices`` and the rollout's
    animation under ``out_dir``, logged to ``wandb_run`` where one is
    given."""

    def __init__(self, out_dir: str, indices: Sequence[int] = (0,), make_animation: bool = True,
                 wandb_run=None):
        self.out_dir = out_dir
        self.indices = list(indices)
        self.make_animation = make_animation
        self.wandb = wandb_run

    def __call__(self, rollout_result, frames, epoch: int) -> List[str]:
        """``rollout_result``: predictions and targets [T, N', F];
        ``frames``: the trajectory's host graph (pos, faces, face_mask,
        n_node, per trajectory or per frame). Returns the files written."""
        n = int(np.asarray(frames.n_node).reshape(-1)[0])
        pos = np.asarray(frames.pos)
        pos = (pos[0] if pos.ndim == 3 else pos)[:n]
        faces = None
        if frames.faces is not None:
            f, fm = np.asarray(frames.faces), np.asarray(frames.face_mask)
            f, fm = (f[0], fm[0]) if f.ndim == 3 else (f, fm)
            faces = f[:int(np.sum(fm))]
        preds = np.asarray(rollout_result.predictions)[:, :n]
        targs = np.asarray(rollout_result.targets)[:, :n]
        artifacts = []
        for i in self.indices:
            if i >= len(preds):
                continue
            p = os.path.join(self.out_dir, f"epoch_{epoch}_frame_{i}.png")
            artifacts.append(render_field_comparison(pos, faces, preds[i], targs[i], p,
                                                     title=f"t={i}"))
        if self.make_animation:
            p = os.path.join(self.out_dir, f"epoch_{epoch}_rollout.gif")
            artifacts.append(render_rollout_animation(pos, faces, preds, targs, p))
        if self.wandb is not None:
            try:
                import wandb

                logs = {f"val/frame_{i}": wandb.Image(a)
                        for i, a in zip(self.indices, artifacts)}
                if self.make_animation:
                    logs["val/rollout"] = wandb.Video(artifacts[-1])
                self.wandb.log(logs)
            except Exception:  # a logging failure must not end the run (callback.py:154)
                pass
        return artifacts
