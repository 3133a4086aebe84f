"""Window state and its tangent-space retraction (port of ``glio_tpu/solver/manifold.py``)."""

from typing import NamedTuple

import torch

from ..utils import quat

POSE_DOF = 15  # δp, δθ, δv, δba, δbg per keyframe.


class WindowState(NamedTuple):
    """Struct-of-arrays state for K keyframes."""
    p: torch.Tensor    # (K, 3) position in local ENU world
    q: torch.Tensor    # (K, 4) attitude body→world, wxyz
    v: torch.Tensor    # (K, 3) velocity
    ba: torch.Tensor   # (K, 3) accel bias
    bg: torch.Tensor   # (K, 3) gyro bias


def tree_where(cond, a, b):
    """Field-wise ``torch.where(cond, a, b)`` over two states of one type,
    nested named tuples included (``WindowStateDdt``)."""
    if isinstance(a, torch.Tensor):
        return torch.where(cond, a, b)
    return type(a)(*(tree_where(cond, x, y) for x, y in zip(a, b)))


def first_leaf(tree) -> torch.Tensor:
    """The first tensor of a (nested) state."""
    while not isinstance(tree, torch.Tensor):
        tree = tree[0]
    return tree


def retract(state: WindowState, delta: torch.Tensor) -> WindowState:
    """Apply a flat tangent vector (K*15,) to the window state."""
    d = delta.reshape(state.p.shape[0], POSE_DOF)
    return WindowState(
        p=state.p + d[:, 0:3],
        q=quat.normalize(quat.mul(state.q, quat.exp(d[:, 3:6]))),
        v=state.v + d[:, 6:9],
        ba=state.ba + d[:, 9:12],
        bg=state.bg + d[:, 12:15],
    )


def local_coordinates(state: WindowState, ref: WindowState) -> torch.Tensor:
    """Inverse of ``retract``: flat tangent of ``state`` around ``ref``."""
    dq = quat.mul(quat.conj(ref.q), state.q)
    d = torch.cat([
        state.p - ref.p,
        quat.log(dq),
        state.v - ref.v,
        state.ba - ref.ba,
        state.bg - ref.bg,
    ], dim=-1)
    return d.reshape(-1)
