"""Quaternion algebra (Hamilton convention, wxyz storage) on torch tensors.

Port of ``glio_tpu/utils/quat.py``: the same formulas in the same order,
broadcasting over leading axes, so that each function agrees with its JAX
counterpart to f64 round-off. ``glio_tpu``'s ``safe_trig`` wrappers are a
workaround for one XLA build's scalar f64 trig and have no counterpart here.
"""

import numpy as np
import torch


def cross(a, b):
    """a × b over the last axis, written out as ``jnp.cross`` computes it."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def norm(x, keepdim=False):
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


def normalize(q):
    return q / norm(q, keepdim=True)


def conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def mul(q1, q2):
    """Hamilton product q1 ⊗ q2 (broadcasts over leading axes)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def rotate(q, v):
    """R(q) v in the expanded form v + 2 (w (u×v) + u×(u×v))."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def to_rotmat(q):
    """Quaternion → 3×3 rotation matrix (body→world)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def from_rotmat(R):
    """3×3 rotation matrix → quaternion without branches (Shepperd's method):
    the four candidates, each scaled by 4·component², and the one of the
    largest diagonal combination taken."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], dim=-1)
    scores = torch.stack([1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
                          1 - m00 - m11 + m22], dim=-1)
    idx = torch.argmax(scores, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)           # (..., 4 candidates, 4)
    q = torch.take_along_dim(cands, idx[..., None, None].expand(idx.shape + (1, 4)),
                             dim=-2)[..., 0, :]
    return positive_hemisphere(normalize(q))


def delta_q(theta):
    """First-order small-angle quaternion [1, θ/2], normalized (``deltaQ``)."""
    half = 0.5 * theta
    return normalize(torch.cat([torch.ones_like(half[..., :1]), half], dim=-1))


def exp(theta):
    """Exact SO(3) exponential as a quaternion.

    The double ``where`` keeps ``sqrt`` off a zero argument, so that
    ``torch.func.jacfwd`` at θ = 0 gives the exact Jacobian and not NaN.
    """
    sq = torch.sum(theta * theta, dim=-1, keepdim=True)
    small = sq < 1e-16
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    half = 0.5 * angle
    k = torch.where(small, 0.5 - sq / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - sq / 8.0, torch.cos(half))
    return torch.cat([w, k * theta], dim=-1)


def positive_hemisphere(q):
    """Flip sign so w ≥ 0 (``unifyQuaternion``)."""
    return torch.where(q[..., 0:1] >= 0, q, -q)


def log(q):
    """Quaternion → rotation vector, hemisphere-safe, with the same
    double-``where`` guard as ``exp`` at the identity."""
    q = positive_hemisphere(q)
    w = q[..., 0:1]
    v = q[..., 1:4]
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    small = sq < 1e-16
    n = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    angle = 2.0 * torch.atan2(n, w)
    k = torch.where(small,
                    2.0 / torch.clamp(w, min=1e-12) * (1.0 - sq / 3.0),
                    angle / n)
    return k * v


def qleft(q):
    """Left-multiplication matrix: ``mul(q, p) == qleft(q) @ p``."""
    w, x, y, z = q.unbind(-1)
    m = torch.stack([
        w, -x, -y, -z,
        x, w, -z, y,
        y, z, w, -x,
        z, -y, x, w,
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (4, 4))


def qright(p):
    """Right-multiplication matrix: ``mul(q, p) == qright(p) @ q``."""
    w, x, y, z = p.unbind(-1)
    m = torch.stack([
        w, -x, -y, -z,
        x, w, z, -y,
        y, -z, w, x,
        z, y, -x, w,
    ], dim=-1)
    return m.reshape(p.shape[:-1] + (4, 4))


def slerp_np(q0, q1, t):
    """Spherical interpolation of one quaternion pair, numpy, for host code
    (the trajectory despiker)."""
    q0 = np.asarray(q0, float)
    q1 = np.asarray(q1, float)
    d = float(q0 @ q1)
    if d < 0:
        q1, d = -q1, -d
    theta = np.arccos(min(max(d, -1.0), 1.0))
    if np.sin(theta) < 1e-6:
        out = (1.0 - t) * q0 + t * q1
    else:
        out = (np.sin((1.0 - t) * theta) * q0
               + np.sin(t * theta) * q1) / np.sin(theta)
    return out / np.linalg.norm(out)
