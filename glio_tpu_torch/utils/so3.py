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


def vee(m):
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def exp(theta):
    """Rotation vector → rotation matrix."""
    return quat.to_rotmat(quat.exp(theta))


def log(R):
    """Rotation matrix → rotation vector."""
    return quat.log(quat.from_rotmat(R))


def _coeffs(angle):
    """Taylor-safe (A, B, C): A = sinθ/θ, B = (1 − cosθ)/θ², C = (θ − sinθ)/θ³."""
    a2 = angle * angle
    small = angle < 1e-6
    safe = torch.where(small, torch.ones_like(angle), angle)
    A = torch.where(small, 1.0 - a2 / 6.0, torch.sin(safe) / safe)
    B = torch.where(small, 0.5 - a2 / 24.0, (1.0 - torch.cos(safe)) / (safe * safe))
    C = torch.where(small, 1.0 / 6.0 - a2 / 120.0, (safe - torch.sin(safe)) / (safe ** 3))
    return A, B, C


def _eye_like(K):
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def left_jacobian(theta):
    """The SO(3) left Jacobian Jl(θ) = I + B·θ^ + C·(θ^)²."""
    _, B, C = _coeffs(quat.norm(theta))
    K = hat(theta)
    return _eye_like(K) + B[..., None, None] * K + C[..., None, None] * (K @ K)


def right_jacobian(theta):
    """Jr(θ) = Jl(−θ)."""
    return left_jacobian(-theta)


def inv_right_jacobian(theta):
    """Jr(θ)⁻¹ in closed form."""
    angle = quat.norm(theta)
    a2 = angle * angle
    small = angle < 1e-6
    safe = torch.where(small, torch.ones_like(angle), angle)
    k = torch.where(small, 1.0 / 12.0 + a2 / 720.0,
                    1.0 / (safe * safe) - (1.0 + torch.cos(safe)) / (2.0 * safe * torch.sin(safe)))
    K = hat(theta)
    return _eye_like(K) + 0.5 * K + k[..., None, None] * (K @ K)
