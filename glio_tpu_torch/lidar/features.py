"""LOAM-style feature extraction (port of ``glio_tpu/lidar/features.py``).

The reference's preprocessing node (``GLIO/src/Preprocessing.cpp``) as
tensor ops: ring assignment from elevation for 16/32/64-beam Velodynes
(:441-487), curvature over ±5 ring neighbours (:529-538), per-ring ×
6-sextant edge/flat picks with neighbour suppression (:549-655), and
gyro-only deskew by slerp over the scan period (:176-200, 222-259).

The JAX package picks greedily with a ``fori_loop`` of masked argmaxes,
vmapped over rings × sextants. Here each pick is one set of tensor ops over
all sextants at once, a fixed number of picks, with no loop over rings or
sextants and no host sync. The curvature adds in the JAX package's order,
and its squared norm is written out, so the card and the CPU give the same
bits and the 1.0 / 0.1 thresholds the same masks.
"""

from typing import NamedTuple

import torch

from ..utils import quat

N_SECTORS = 6
CURV_HALF_WINDOW = 5


class FeatureParams(NamedTuple):
    edge_threshold: float = 1.0     # config_urban_hk.yaml edgeThreshold
    surf_threshold: float = 0.1     # surfThreshold
    max_sharp: int = 2
    max_less_sharp: int = 10
    max_flat: int = 4
    min_range: float = 3.0          # removeClosedPointCloud(3m)
    suppress_halfwidth: int = 5


def _sq_norm(v):
    """(x·x + y·y) + z·z over the last axis, in that order on every device."""
    return (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2]


def ring_from_elevation(points, n_scans: int = 32):
    """Velodyne ring index from elevation angle (``Preprocessing.cpp:441-487``).

    16-beam: ±15° at 2°; 32-beam: −30.67°…+10.67° at 4/3°; 64-beam: +2°…
    −24.33°, split scheme. Returns (ring int32, in_range bool), in_range
    false for angles off the table.
    """
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    angle = torch.rad2deg(torch.atan2(z, torch.sqrt(x * x + y * y)))
    if n_scans == 16:
        ring = torch.round((angle + 15.0) / 2.0).to(torch.int32)
    elif n_scans == 32:
        ring = torch.round((angle + 92.0 / 3.0) * 3.0 / 4.0).to(torch.int32)
    elif n_scans == 64:
        upper = torch.round((angle + 2.0) * 3.0 + 0.5).to(torch.int32)
        lower = torch.round(n_scans / 2.0 + (angle + 2.0) * 2.0 + 0.5).to(torch.int32)
        ring = torch.where(angle >= -8.83, upper, lower)
    else:
        raise ValueError(f"unsupported n_scans={n_scans}")
    ok = (ring >= 0) & (ring < n_scans)
    return ring.clamp(0, n_scans - 1), ok


def curvature(points, valid):
    """LOAM curvature per ring point: ‖Σ_{j=−5..5, j≠0}(p_j − p_0)‖².

    points (R, P, 3) ring-ordered, valid (R, P). A point whose ±5
    neighbourhood holds an invalid entry, or wraps past a ring's end, gets
    −1 (excluded), as the reference skips ring boundaries.
    """
    h = CURV_HALF_WINDOW
    acc = -2.0 * h * points
    ok = valid
    for off in range(1, h + 1):
        acc = acc + torch.roll(points, off, dims=1) + torch.roll(points, -off, dims=1)
        ok = ok & torch.roll(valid, off, dims=1) & torch.roll(valid, -off, dims=1)
    P = points.shape[1]
    pos = torch.arange(P, device=points.device)
    ok = ok & ((pos >= h) & (pos < P - h))[None, :]
    c = _sq_norm(acc)
    return torch.where(ok, c, torch.full_like(c, -1.0)), ok


def greedy_select(score, n_pick: int, suppress_halfwidth: int):
    """Greedy masked argmax with ±halfwidth suppression, in every row at once.

    score (B, S): each row one sextant, −inf where not eligible. Each of the
    ``n_pick`` rounds takes every row's first maximum; where it is finite,
    marks it picked and suppresses it and its neighbours within the row.
    Returns the (B, S) bool mask of picks: the JAX package's
    ``_greedy_select`` applied to each row.
    """
    B, S = score.shape
    pos = torch.arange(S, device=score.device)[None, :]
    picked = torch.zeros((B, S), dtype=torch.bool, device=score.device)
    neg_inf = torch.full_like(score, -float("inf"))
    for _ in range(n_pick):
        i = torch.argmax(score, dim=1, keepdim=True)               # first maximum
        s_i = torch.gather(score, 1, i)
        can = torch.isfinite(s_i) & (s_i > -float("inf"))
        picked = picked | ((pos == i) & can)
        score = torch.where(can & ((pos - i).abs() <= suppress_halfwidth), neg_inf, score)
    return picked


def extract_features(points, valid, params: FeatureParams = FeatureParams()):
    """Edge/flat feature masks over a range-image scan.

    points (R, P, 3) ring-ordered (deskewed, sensor frame); valid (R, P).
    Returns a dict of (R, P) bool masks ``sharp``, ``less_sharp``, ``flat``,
    ``less_flat`` and the ``curvature``. ``less_flat`` is every valid
    non-edge point below the edge threshold (the reference also voxel-filters
    them at 0.4 m, which the caller does).
    """
    R, P = valid.shape
    valid = valid & (torch.sqrt(_sq_norm(points)) > params.min_range)
    c, ok = curvature(points, valid)
    sec = P // N_SECTORS
    usable = sec * N_SECTORS
    c_s = c[:, :usable].reshape(R * N_SECTORS, sec)
    ok_s = ok[:, :usable].reshape(R * N_SECTORS, sec)
    neg_inf = torch.full_like(c_s, -float("inf"))
    edge_score = torch.where(ok_s & (c_s > params.edge_threshold), c_s, neg_inf)
    flat_score = torch.where(ok_s & (c_s < params.surf_threshold) & (c_s >= 0), -c_s, neg_inf)
    h = params.suppress_halfwidth
    sel_less_sharp = greedy_select(edge_score, params.max_sharp + params.max_less_sharp, h)
    sel_sharp = greedy_select(edge_score, params.max_sharp, h)
    sel_flat = greedy_select(flat_score, params.max_flat, h)

    def unshape(m):
        full = torch.zeros((R, P), dtype=torch.bool, device=m.device)
        full[:, :usable] = m.reshape(R, usable)
        return full

    less_sharp = unshape(sel_less_sharp)
    less_flat = valid & ok & ~less_sharp & (c <= params.edge_threshold)
    return {"sharp": unshape(sel_sharp), "less_sharp": less_sharp,
            "flat": unshape(sel_flat), "less_flat": less_flat, "curvature": c}


def deskew(points, rel_time, q_scan, q_lb):
    """Gyro-only motion compensation (``Preprocessing.cpp:176-200``): each
    point rotated by slerp(identity, q_scan, t_rel) conjugated by the
    lidar-body extrinsic, p' = (q_lb⁻¹ ⊗ slerp(t) ⊗ q_lb) · p."""
    t = torch.clamp(rel_time, 0.0, 1.0)[..., None]
    shape = t.shape[:-1] + (4,)
    ident = torch.tensor([1.0, 0, 0, 0], dtype=q_scan.dtype, device=q_scan.device)
    qs = quat.slerp(ident.expand(shape), q_scan.expand(shape), t)
    q_full = quat.mul(quat.conj(q_lb), quat.mul(qs, q_lb))
    return quat.rotate(q_full, points)
