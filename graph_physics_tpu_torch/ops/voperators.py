"""Discrete vector calculus on padded meshes: the physics losses' gradients.

Counterpart of graph_physics_tpu/ops/voperators.py (:35-190), in fp32 torch
ops (these are not Pallas kernels in the JAX package, so they get no hand
kernel):

  * ``gradient_fd``: inverse-square-distance weighted finite differences
    over the directed edges, summed at the receiver;
  * ``gradient_wls``: per-element least squares with closed-form 2x2 / 3x3
    solves (``_solve_elements``, ``_inv_small``; the min-norm solution for
    surface triangles in 3-D), scattered to the vertices weighted by the
    element volume;
  * ``gradient`` dispatches on the method; ``convection`` is (u·∇)u and
    ``divergence`` the trace of the gradient.

Padded edges and faces are masked before every sum. A field may carry
batch axes between the node axis and the feature axis (``[N, B, F]``, the
packed layout, with the topology shared): each sample's gradient is the
one JAX computes for that sample alone, returned as ``[N, B, F, D]``.
"""

from __future__ import annotations

from typing import Optional

import torch

from graph_physics_tpu_torch.ops import segment

_EPS = 1e-8


def gradient_fd(pos: torch.Tensor, field: torch.Tensor, senders: torch.Tensor,
                receivers: torch.Tensor, edge_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Inverse-square-distance weighted finite-difference gradient
    [N, ..., F, D] of ``field`` [N, ..., F] (voperators.py:gradient_fd)."""
    pos = pos.float()
    field = field.float()
    n = pos.shape[0]
    s, r = senders.long(), receivers.long()
    dx = pos[s] - pos[r]  # [E, D]
    du = field[s] - field[r]  # [E, ..., F]
    dist2 = torch.sum(dx * dx, dim=-1)
    w = 1.0 / (dist2 + _EPS)  # [E]
    ones = (1,) * (du.ndim - 1)  # the batch axes and F
    g_e = du[..., :, None] * dx.view((-1,) + ones + dx.shape[-1:]) \
        * (w * w).view((-1,) + ones + (1,))  # [E, ..., F, D]
    grad = segment.segment_sum(g_e, r, n, mask=edge_mask)
    w_sum = segment.segment_sum(w, r, n, mask=edge_mask)
    return grad / (w_sum.view((n,) + (1,) * (grad.ndim - 1)) + _EPS)


def _inv_small(a: torch.Tensor) -> torch.Tensor:
    """Batched closed-form inverse of 2x2 or 3x3 matrices, the determinant
    guarded by ``_EPS`` (voperators.py:_inv_small)."""
    d = a.shape[-1]
    eps = torch.full((), _EPS, dtype=a.dtype, device=a.device)
    if d == 2:
        det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
        det = torch.where(det.abs() < _EPS, eps, det)
        inv = torch.stack([torch.stack([a[..., 1, 1], -a[..., 0, 1]], dim=-1),
                           torch.stack([-a[..., 1, 0], a[..., 0, 0]], dim=-1)], dim=-2)
        return inv / det[..., None, None]
    if d == 3:
        c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
        c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
        c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
        det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
        det = torch.where(det.abs() < _EPS, eps, det)
        c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
        c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
        c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
        c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
        c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
        c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
        inv = torch.stack([torch.stack([c00, c10, c20], dim=-1),
                           torch.stack([c01, c11, c21], dim=-1),
                           torch.stack([c02, c12, c22], dim=-1)], dim=-2)
        return inv / det[..., None, None]
    raise ValueError(f"only 2x2/3x3 closed-form inverses supported, got {d}x{d}")


def _solve_elements(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """X [M, dim_x, F] of A X = B per element, A [M, D, dim_x], B [M, D, F]
    (voperators.py:_solve_elements): A⁻¹B when D == dim_x, else the
    min-norm Aᵀ(AAᵀ)⁻¹B."""
    d, dim_x = a.shape[1], a.shape[2]
    if d == dim_x:
        return _inv_small(a) @ b
    at = a.transpose(-1, -2)
    return at @ (_inv_small(a @ at) @ b)


def gradient_wls(pos: torch.Tensor, field: torch.Tensor, faces: torch.Tensor,
                 face_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Element-wise least-squares gradient [N, ..., F, dim_x] of ``field``
    [N, ..., F] over the simplices ``faces`` [M, D+1], each element's
    gradient weighted by its volume at its vertices
    (voperators.py:gradient_wls)."""
    pos = pos.float()
    field = field.float()
    n, dim_x = pos.shape
    faces = faces.long()
    d = faces.shape[1] - 1
    batch = field.shape[1:-1]
    m = faces.shape[0]

    ep = pos[faces]  # [M, D+1, dim_x]
    ef = field[faces]  # [M, D+1, ..., F]
    a = ep[:, 1:, :] - ep[:, :1, :]  # [M, D, dim_x]
    b = (ef[:, 1:] - ef[:, :1]).reshape(m, d, -1)  # [M, D, (...)·F]
    x = _solve_elements(a, b)  # [M, dim_x, (...)·F]
    grad_elems = x.reshape((m, dim_x) + tuple(field.shape[1:])).movedim(1, -1)

    if d == 2:
        v1, v2 = a[:, 0, :], a[:, 1, :]
        if dim_x == 3:
            vol = 0.5 * torch.linalg.norm(torch.linalg.cross(v1, v2), dim=-1)
        else:
            vol = 0.5 * (v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0]).abs()
    elif d == 3:
        vol = torch.linalg.det(a).abs() / 6.0
    else:
        raise ValueError(f"unsupported element dimension D={d}")
    if face_mask is not None:
        vol = torch.where(face_mask, vol, torch.zeros_like(vol))

    gsum = field.new_zeros((n,) + tuple(grad_elems.shape[1:]))
    wsum = field.new_zeros((n,))
    contrib = grad_elems * vol.view((m,) + (1,) * (len(batch) + 2))
    for i in range(d + 1):
        idx = faces[:, i]
        gsum = gsum + segment.segment_sum(contrib, idx, n)
        wsum = wsum + segment.segment_sum(vol, idx, n)
    return gsum / torch.clamp(wsum, min=1e-12).view((n,) + (1,) * (gsum.ndim - 1))


def gradient(pos: torch.Tensor, field: torch.Tensor, senders: Optional[torch.Tensor] = None,
             receivers: Optional[torch.Tensor] = None,
             edge_mask: Optional[torch.Tensor] = None, faces: Optional[torch.Tensor] = None,
             face_mask: Optional[torch.Tensor] = None,
             method: str = "finite_diff") -> torch.Tensor:
    """The gradient by ``method`` (voperators.py:gradient)."""
    if method == "least_squares":
        if faces is None:
            raise ValueError("least_squares gradient requires faces")
        return gradient_wls(pos, field, faces, face_mask)
    if method == "finite_diff":
        if senders is None or receivers is None:
            raise ValueError("finite_diff gradient requires edges")
        return gradient_fd(pos, field, senders, receivers, edge_mask)
    raise ValueError(f"unknown gradient method: {method}")


def convection(field: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """(u·∇)u per node, einsum('...f,...fd->...f') (voperators.py:convection)."""
    return torch.einsum("...f,...fd->...f", field.to(grad.dtype), grad)


def divergence(grad: torch.Tensor) -> torch.Tensor:
    """Trace of the per-node gradient tensor (voperators.py:divergence)."""
    k = min(grad.shape[-1], grad.shape[-2])
    return torch.diagonal(grad[..., :k, :k], dim1=-2, dim2=-1).sum(-1)
