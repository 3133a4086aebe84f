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
