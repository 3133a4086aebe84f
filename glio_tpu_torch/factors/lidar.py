"""LiDAR point-to-plane factors (port of ``glio_tpu/factors/lidar.py:29-65``).

``plane_norm_residual`` is ``LidarPlaneNormFactor``
(``GLIO/include/factors/LidarKeyframeFactor.h:73-122``):
r = score · (nᵀ(q · q_lb⁻¹(p − t_lb) + t) + d).
``binary_plane_residual`` is ``BinaryLidarPlaneNormFactor`` (``:124-164``):
r = score · (R(q₂)n) · ((q₁p + t₁) − (q₂c + t₂)).
"""

import torch

from ..utils import quat


def body_from_lidar(p_l, q_lb, t_lb):
    """Lidar-frame point → body frame: p_b = q_lb⁻¹ (p_l − t_lb)."""
    return quat.rotate(quat.conj(q_lb), p_l - t_lb)


def plane_norm_residual(p_l, normal, d, score, t, q, q_lb, t_lb, mask):
    """Masked unary scan-to-map point-to-plane residuals.

    p_l (..., N, 3) lidar-frame points; normal (..., N, 3) and d (..., N)
    world planes; score (..., N) weights; t (..., 3), q (..., 4) keyframe
    pose; mask (..., N). Returns (..., N).
    """
    p_b = body_from_lidar(p_l, q_lb, t_lb)
    p_w = quat.rotate(q[..., None, :], p_b) + t[..., None, :]
    r = score * (torch.sum(normal * p_w, dim=-1) + d)
    return torch.where(mask, r, torch.zeros_like(r))


def binary_plane_residual(p_b, normal_b, cent_b, score, t1, q1, t2, q2, mask):
    """Masked scan-to-multiscan point-to-plane residuals between two
    keyframes: points p_b (..., N, 3) in keyframe 1's body frame against
    planes (normal_b, cent_b) (..., N, 3) in keyframe 2's, both taken to
    the world by the poses (t1, q1), (t2, q2) (..., 3) / (..., 4); score
    and mask (..., N). Returns (..., N)."""
    p_w = quat.rotate(q1[..., None, :], p_b) + t1[..., None, :]
    n_w = quat.rotate(q2[..., None, :], normal_b)
    c_w = quat.rotate(q2[..., None, :], cent_b) + t2[..., None, :]
    r = score * torch.sum(n_w * (p_w - c_w), dim=-1)
    return torch.where(mask, r, torch.zeros_like(r))
