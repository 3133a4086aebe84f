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

from ..solver.linalg import eigh3, solve_3x3


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
    solve_dt = torch.float64 if dtype == torch.float32 else dtype
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


def _sum_neighbours(x):
    """Sum over the neighbour axis (-2), one neighbour after the other, so
    that the CPU and the card add in the same order."""
    acc = x[..., 0, :]
    for k in range(1, x.shape[-2]):
        acc = acc + x[..., k, :]
    return acc


def fit_planes_centroid(neigh, neigh_valid, min_planarity: float = 0.0):
    """Centroid and scatter-matrix plane fit: (normal, centroid, planarity,
    valid), for batch level 1's binary plane factors, which carry a plane
    as (normal, centroid) in the other keyframe's body frame.

    neigh (..., K, 3) f32, neigh_valid (..., K) bool. Planarity is
    1 − 3λ₀/(λ₀+λ₁+λ₂) of the scatter matrix's eigenvalues (1 for a perfect
    plane, 0 for an isotropic cloud); the normal is λ₀'s eigenvector, with
    an arbitrary sign. Centroid and scatter matrix are f32, as in the JAX
    package, summed over the neighbours in order; the 3×3 eigensystem is
    solved in f64 by Jacobi rotations (``solver.linalg.eigh3``) and cast
    back, so the CPU and the card give the same bits, and JAX's f32
    ``eigh`` agrees to its own f32 error.
    """
    dtype = neigh.dtype
    m = neigh_valid.to(dtype)[..., None]
    cnt = torch.clamp(torch.sum(m, dim=-2), min=1.0)              # (..., 1), exact
    cent = _sum_neighbours(neigh * m) / cnt                        # (..., 3)
    dc = (neigh - cent[..., None, :]) * m
    c = cnt[..., 0]

    def scatter(i, j):
        return (_sum_neighbours(dc[..., i:i + 1] * dc[..., j:j + 1])[..., 0] / c).to(torch.float64)

    w64, V64 = eigh3(scatter(0, 0), scatter(0, 1), scatter(0, 2), scatter(1, 1),
                     scatter(1, 2), scatter(2, 2))
    w, normal = w64.to(dtype), V64[..., :, 0].to(dtype)
    tr = (w[..., 0] + w[..., 1]) + w[..., 2]
    planarity = 1.0 - 3.0 * w[..., 0] / torch.clamp(tr, min=1e-12)
    valid = (c >= 3) & (planarity >= min_planarity)
    return normal, cent, planarity, valid
