"""Batched k-point plane fits (port of ``glio_tpu/lidar/plane_fit.py:34-122``).

Fits n with A·n = −1 over each query's neighbours, checks that every
neighbour lies within ``plane_tol`` of the plane, and weights the fit by
w = 1 − 0.9·|nᵀq + d| / ‖q‖^(1/4) (``LidarOdometry.cpp:343-404``). The
centring runs in f32; the 3×3 solve and the Sherman–Morrison scalars run
in f64, exactly as in the JAX package, because the f32 cofactors of a
rank-2 covariance lose about three digits of the plane offset.
"""

from typing import NamedTuple

import torch

from ..solver.linalg import solve_3x3
from .. import precision as P


EPS = 1e-9   # Tikhonov floor of the 3×3 solve and the normal-length guard


class PlaneFit(NamedTuple):
    normal: torch.Tensor   # (Q, 3) unit normals
    d: torch.Tensor        # (Q,) plane offset: nᵀp + d ≈ 0
    valid: torch.Tensor    # (Q,) bool: well-conditioned and planar
    weight: torch.Tensor   # (Q,) distance-based weight (pre-threshold)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def fit_planes(neigh, neigh_valid, query, plane_tol: float = 0.06) -> PlaneFit:
    """neigh (Q, K, 3), neigh_valid (Q, K) bool, query (Q, 3)."""
    dtype = neigh.dtype
    m = neigh_valid.to(dtype)[..., None]
    cnt = torch.clamp(torch.sum(m, dim=-2), min=1.0)          # (Q, 1)
    c = torch.sum(neigh * m, dim=-2) / cnt                     # (Q, 3)
    dc = (neigh - c[:, None, :]) * m
    cov = torch.sum(dc[..., :, None] * dc[..., None, :], dim=-3)
    solve_dt = P.F64 if dtype == torch.float32 else dtype
    c64 = c.to(solve_dt)
    y = solve_3x3(cov.to(solve_dt), c64, eps=EPS)
    cty = _dot(c64, y)
    cnt64 = cnt.to(solve_dt)
    n_raw = (-cnt64 * y / (1.0 + cnt64[..., 0] * cty)[:, None]).to(dtype)
    norm = torch.sqrt(_dot(n_raw, n_raw))
    good_norm = norm > EPS
    inv_norm = 1.0 / torch.where(good_norm, norm, torch.ones_like(norm))
    normal = n_raw * inv_norm[..., None]
    d = inv_norm

    s = _dot(c, normal) + d
    dist = torch.abs(_dot(neigh - c[:, None, :], normal[:, None, :]) + s[:, None])
    dist = torch.where(neigh_valid, dist, torch.zeros_like(dist))
    planar = torch.all(dist <= plane_tol, dim=-1)
    k_count = torch.sum(neigh_valid, dim=-1)
    valid = planar & good_norm & (k_count >= 3)

    pd = _dot(query - c, normal) + s
    qn = torch.sqrt(_dot(query, query))
    weight = 1.0 - 0.9 * torch.abs(pd) / torch.sqrt(torch.sqrt(torch.clamp(qn, min=EPS)))
    return PlaneFit(normal=normal, d=d, valid=valid, weight=weight)
