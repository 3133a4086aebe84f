"""Relative-pose chain and prior factors (port of ``glio_tpu/factors/pose.py``).

Counterparts of ``GLIO/include/factors/LidarPoseFactor.h`` and
``PriorFactor.h``, evaluated as one masked batch per factor type:

* ``relative_pose_residual``  ← LidarPoseFactorAutoDiff (:11-52, weight
  0.2 on both blocks) and LidarPoseFactorBatchRelativeAutoDiff (:54-95,
  weights 10/20) — the weights are arguments:
  r = [w_q · 2·vec(Δq⁻¹ q₁⁻¹ q₂),  w_p · (q₁⁻¹(p₂ − p₁) − Δp)]
* ``anchored_pose_residual``  ← LidarPoseLeft/RightFactorAutoDiff
  (:128-221): the same residual with one side a constant pose.
* ``position_prior_residual`` ← LidarPoseFactorAutoDiffBatch (:97-125),
  weight 1.2.
* ``speed_bias_prior_residual`` ← SpeedBiasPriorFactorAutoDiff
  (PriorFactor.h:10-40), diagonal weights (8, 8, 1, ..., 1).

No caller in the port uses them yet (as in the JAX package, where the batch
assembles its relative rows with analytic Jacobians of its own).
"""

import torch

from ..utils import quat


def _masked(r, mask):
    return r if mask is None else torch.where(mask[..., None], r, torch.zeros_like(r))


def relative_pose_residual(p1, q1, p2, q2, delta_p, delta_q, w_q, w_p, mask):
    """(N, 6) masked residuals of relative-pose factors between pose pairs."""
    r_q = 2.0 * quat.mul(quat.conj(delta_q), quat.mul(quat.conj(q1), q2))[..., 1:4]
    r_p = quat.rotate(quat.conj(q1), p2 - p1) - delta_p
    w_q = torch.as_tensor(w_q, dtype=r_q.dtype, device=r_q.device)
    w_p = torch.as_tensor(w_p, dtype=r_p.dtype, device=r_p.device)
    return _masked(torch.cat([w_q[..., None] * r_q, w_p[..., None] * r_p], dim=-1), mask)


def anchored_pose_residual(p_free, q_free, p_anchor, q_anchor, delta_p, delta_q, w, mask,
                           anchor_is_left=True):
    """The relative-pose residual with one side held constant: the anchor
    plays pose 1 (``anchor_is_left``, LidarPoseLeftFactorAutoDiff) or pose 2
    (the Right variant). Reference weight 0.2 on every row."""
    if anchor_is_left:
        return relative_pose_residual(p_anchor, q_anchor, p_free, q_free, delta_p, delta_q,
                                      w, w, mask)
    return relative_pose_residual(p_free, q_free, p_anchor, q_anchor, delta_p, delta_q, w, w,
                                  mask)


def position_prior_residual(p, target, weight=1.2, mask=None):
    return _masked(weight * (p - target), mask)


SPEED_BIAS_WEIGHTS = (8.0, 8.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)


def speed_bias_prior_residual(v, ba, bg, v0, ba0, bg0, mask=None):
    """(N, 9) prior pulling speed and biases to a snapshot (used after loop
    closures when marginalization is reset — ``Estimator.cpp`` marg=false
    path)."""
    sb = torch.cat([v, ba, bg], dim=-1)
    sb0 = torch.cat([v0, ba0, bg0], dim=-1)
    w = torch.tensor(SPEED_BIAS_WEIGHTS, dtype=sb.dtype, device=sb.device)
    return _masked(w * (sb - sb0), mask)
