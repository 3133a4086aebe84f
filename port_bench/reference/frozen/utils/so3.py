"""SO(3) utilities: hat / vee, exp / log on matrices, left and right Jacobians
(port of ``glio_tpu/utils/so3.py``)."""

import torch

from . import quat


def hat(v):
    """Skew-symmetric matrix such that hat(a) @ b == cross(a, b)."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([
        zero, -z, y,
        z, zero, -x,
        -y, x, zero,
    ], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def exp(theta):
    """Rotation vector → rotation matrix."""
    return quat.to_rotmat(quat.exp(theta))


def log(R):
    """Rotation matrix → rotation vector."""
    return quat.log(quat.from_rotmat(R))
