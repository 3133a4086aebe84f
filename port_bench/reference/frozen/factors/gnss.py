"""GNSS factor evaluators (port of ``glio_tpu/factors/gnss.py``).

``r_ecef_local`` and ``local_to_ecef`` take the estimator's local frame into
ECEF through the anchor and ``yaw_enu_local`` (dd_psr_factor.hpp:33-40). The
evaluators of the reference's Ceres costs take tensors of any leading shape
(the window's slots), and are differentiable:

* ``dd_psr_residual`` ← dd_psr_factor_20 (``factors/dd_psr_factor.hpp``):
  the position interpolated between two keyframes by a time ratio, then the
  whitened double differences per constellation with the ×0.05 annealed
  outlier down-weight;
* ``doppler_residual`` ← tcdopplerFactor (``factors/dopp_factor.hpp:19-85``):
  range rate with the Sagnac term, interpolated position and velocity, the
  epoch's receiver clock drift, the satellite clock drift removed;
* ``clock_drift_residual`` ← constantClockDriftFactor (``:88-103``).
"""

import torch

from ..gnss.dd import dd_residual
from ..utils.coords import CLIGHT, OMGE, ecef2enu_rotmat, ecef2llh


def r_ecef_local(anchor_ecef, yaw_enu_local):
    """R_ecef_local = R_ecef_enu(anchor) · Rz(yaw): local-world
    coordinates → ECEF deltas."""
    yaw = torch.as_tensor(yaw_enu_local, dtype=anchor_ecef.dtype,
                          device=anchor_ecef.device)
    sy, cy = torch.sin(yaw), torch.cos(yaw)
    zero, one = torch.zeros_like(yaw), torch.ones_like(yaw)
    R_enu_local = torch.stack([cy, -sy, zero, sy, cy, zero,
                               zero, zero, one]).reshape(3, 3)
    R_ecef_enu = ecef2enu_rotmat(ecef2llh(anchor_ecef)).T
    return R_ecef_enu @ R_enu_local


def local_to_ecef(p_local, anchor_ecef, yaw_enu_local, lever_arm=None):
    R = r_ecef_local(anchor_ecef, yaw_enu_local)
    if lever_arm is not None:
        p_local = p_local + lever_arm
    return torch.einsum("ij,...j->...i", R, p_local) + anchor_ecef


def dd_psr_residual(p_i, p_j, ratio, anchor_ecef, yaw_enu_local, station_ecef, sat_pos,
                    psr_rov, psr_sta, valid, system, master, whiten, threshold=1e9,
                    lever_arm=None):
    """Whitened DD pseudorange residuals of epochs bound to pose pairs.

    p_i, p_j (..., 3): local keyframe positions; the epoch sits between them
    with interpolation ``ratio`` (...,): ratio·p_i + (1 − ratio)·p_j
    (dd_psr_factor.hpp:42). The slot tensors carry the same leading axes.
    Returns (..., n_sys, M) masked residuals.
    """
    p_local = ratio[..., None] * p_i + (1.0 - ratio[..., None]) * p_j
    p_ecef = local_to_ecef(p_local, anchor_ecef, yaw_enu_local, lever_arm)
    return dd_residual(p_ecef, sat_pos, psr_rov, psr_sta, station_ecef, valid, system,
                       master, whiten, threshold)


def doppler_residual(p_i, v_i, p_j, v_j, ratio, rcv_ddt, anchor_ecef, yaw_enu_local,
                     sat_pos, sat_vel, sat_ddt, dopp_rng_rate, valid, var, lever_arm=None):
    """Per-satellite Doppler residuals (..., M), masked.

    ``dopp_rng_rate`` is the measured range rate in m/s (−doppler·λ as the
    converter stores it); residual = (h(x) − meas) / var, the tcdopplerFactor
    sign convention. p, v (..., 3); ratio and rcv_ddt (...,).
    """
    R = r_ecef_local(anchor_ecef, yaw_enu_local)
    r = ratio[..., None]
    p_local = r * p_i + (1.0 - r) * p_j
    if lever_arm is not None:
        p_local = p_local + lever_arm
    v_local = r * v_i + (1.0 - r) * v_j
    P = (p_local @ R.T + anchor_ecef)[..., None, :]
    V = (v_local @ R.T)[..., None, :]
    d = sat_pos - P
    los = d / torch.clamp(torch.linalg.norm(d, dim=-1), min=1.0)[..., None]
    sagnac = OMGE / CLIGHT * (
        sat_vel[..., 0] * P[..., 1] + sat_pos[..., 0] * V[..., 1]
        - sat_vel[..., 1] * P[..., 0] - sat_pos[..., 1] * V[..., 0])
    est = torch.sum((sat_vel - V) * los, dim=-1) + sagnac + rcv_ddt[..., None] - sat_ddt
    res = (est - dopp_rng_rate) / var
    return torch.where(valid, res, torch.zeros_like(res))


def clock_drift_residual(rcv_ddt, mask=None):
    """Consecutive-epoch clock-drift tie: r_k = ddt_k − ddt_{k+1}."""
    r = rcv_ddt[:-1] - rcv_ddt[1:]
    if mask is not None:
        r = torch.where(mask, r, torch.zeros_like(r))
    return r
