"""Training-noise injection (counterpart of graph_physics_tpu/training/noise.py).

Gaussian noise on the column ranges ``x[..., s:e]`` of NORMAL nodes only,
with an optional cosine curriculum ``10·σ·(1 + cos(tπ))``. The JAX package
threads a PRNG key; here an explicit ``torch.Generator`` on the graph's
device draws one ``randn`` per range, in the order of the ranges.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch

from graph_physics_tpu_torch.core.graph import MeshGraph
from graph_physics_tpu_torch.core.nodetype import NodeType


def _as_list(v, n=None):
    if isinstance(v, (int, float)):
        return [v] * (n or 1)
    return list(v)


def add_noise(
    graph: MeshGraph,
    generator: torch.Generator,
    noise_index_start: Union[int, Sequence[int]],
    noise_index_end: Union[int, Sequence[int]],
    noise_scale: Union[float, Sequence[float]],
    t: Optional[float] = None,
) -> MeshGraph:
    """``graph`` with noise added to x[..., s:e] on NORMAL nodes.

    ``t`` in [0, 1] (training progress) enables the cosine curriculum.
    """
    starts, ends = _as_list(noise_index_start), _as_list(noise_index_end)
    scales = _as_list(noise_scale, len(starts))
    if len(starts) != len(ends) or len(scales) != len(starts):
        raise ValueError("noise index/scale lists must have equal length")

    x = graph.x
    normal = graph.node_type == int(NodeType.NORMAL)
    normal = normal.view(normal.shape + (1,) * (x.ndim - normal.ndim))
    x = x.clone()
    for s, e, scale in zip(starts, ends, scales):
        if t is not None:
            scale = 10.0 * scale * (1.0 + math.cos(float(t) * math.pi))
        feature = x[..., s:e]
        noise = torch.randn(feature.shape, generator=generator, device=x.device,
                            dtype=feature.dtype) * scale
        x[..., s:e] = feature + torch.where(normal, noise, torch.zeros((), dtype=noise.dtype,
                                                                       device=x.device))
    return graph.replace(x=x)
