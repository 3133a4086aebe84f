"""GNSS geometry of the factors (port of ``glio_tpu/factors/gnss.py:25-41``).

``r_ecef_local`` and ``local_to_ecef`` take the estimator's local frame into
ECEF through the anchor and ``yaw_enu_local`` (dd_psr_factor.hpp:33-40); the
batch stage's DD rows use them. The factor evaluators ``dd_psr_residual``,
``doppler_residual`` and ``clock_drift_residual`` belong to GNSS in the
sliding window, which is not ported yet.
"""

import torch

from ..utils.coords import ecef2enu_rotmat, ecef2llh


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
