"""SO(3) helpers the sliding-window slice needs (port of ``glio_tpu/utils/so3.py``)."""

import torch


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
