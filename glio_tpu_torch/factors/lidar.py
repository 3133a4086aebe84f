"""LiDAR residual evaluators (port of ``glio_tpu/factors/lidar.py``).

``plane_norm_residual`` is ``LidarPlaneNormFactor``
(``GLIO/include/factors/LidarKeyframeFactor.h:73-122``):
r = score · (nᵀ(q · q_lb⁻¹(p − t_lb) + t) + d).
``binary_plane_residual`` is ``BinaryLidarPlaneNormFactor`` (``:124-164``):
r = score · (R(q₂)n) · ((q₁p + t₁) − (q₂c + t₂)).
Off the pipeline's paths, as in the JAX package: ``plane_incre_residual``
(``LidarPlaneNormIncreFactor``, :222-257), ``edge_residual``
(``LidarEdgeFactor``, :12-70), ``relative_attitude_residual``
(``delta_q_factor_auto``, :281-304) and ``roll_pitch_residual``
(``roll_pitch_factor_auto``, :261-279). These four take one pose (t (3,),
q (4,)) for all N rows, as the JAX functions do.
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


def plane_incre_residual(p_l, normal, d, t, q, mask):
    """Odometry front end's point-to-plane rows r = nᵀ(q p + t) + d (points
    already in the body frame), masked; (N,)."""
    p_w = quat.rotate(q, p_l) + t
    r = torch.sum(normal * p_w, dim=-1) + d
    return torch.where(mask, r, torch.zeros_like(r))


def edge_residual(p_l, line_a, line_b, s, t, q, q_lb, t_lb, mask):
    """Point-to-line distances s · |(p − a) × (p − b)| / |a − b|, masked; (N,)."""
    p_b = body_from_lidar(p_l, q_lb, t_lb)
    p_w = quat.rotate(q, p_b) + t
    nu = quat.cross(p_w - line_a, p_w - line_b)
    de = line_a - line_b
    r = s * quat.norm(nu) / torch.clamp(quat.norm(de), min=1e-12)
    return torch.where(mask, r, torch.zeros_like(r))


def relative_attitude_residual(q_i, q_j, delta_q, weight, mask):
    """r = weight · vec(Δq⁻¹ ⊗ q_i⁻¹ ⊗ q_j), masked; (N, 3)."""
    dq = quat.mul(quat.conj(delta_q), quat.mul(quat.conj(q_i), q_j))
    r = weight[..., None] * dq[..., 1:4]
    return torch.where(mask[..., None], r, torch.zeros_like(r))


def roll_pitch_residual(q, up_vec, weight=20.0):
    """r = weight · (1 − upᵀ(R(q) ẑ))."""
    z = torch.zeros_like(up_vec)
    z[..., 2] = 1.0
    return weight * (1.0 - torch.sum(up_vec * quat.rotate(q, z), dim=-1))
