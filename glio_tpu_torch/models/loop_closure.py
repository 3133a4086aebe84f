"""Loop-closure detection, ICP verification and pose-graph correction (port of ``glio_tpu/models/loop_closure.py:35-191``).

The reference's ``loopClosureThread`` (Estimator.cpp:5090-5273; params
``lc_search_radius``, ``lc_map_width``, ``lc_icp_thres``,
``lc_time_thres``), here one pass over a finished trajectory:

* ``detect_loops`` (host numpy): for every 10th keyframe the nearest one at
  least ``time_thresh`` older and within ``search_radius``;
* ``verify_loop``: three ICP rounds of the current scan against a local map
  around the old keyframe, each a 5-NN search (``ops.knn.knn``, the CUDA
  kernel on the card), plane fits and an 8-iteration 6-dof LM; accepted on
  the point-to-plane RMS below ``lc_icp_thres``;
* ``solve_with_loops``: Gauss-Newton over the odometry chain plus the loop
  edges, which break the band: banded Cholesky and a Woodbury update.
"""

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..config import GlioConfig
from ..lidar import neighbors, plane_fit
from ..ops.knn import knn
from ..solver import banded, dense
from ..utils import quat
from .batch import _scatter_pair
from .lc_fusion import chain_plans, edge_jacobians

F64 = torch.float64
F32 = torch.float32
DOF = 6


class LoopCandidate(NamedTuple):
    cur: int
    old: int


class Pose(NamedTuple):
    p: torch.Tensor
    q: torch.Tensor


def detect_loops(p, kf_time, search_radius=25.0, time_thresh=30.0,
                 stride: int = 10, max_loops: int = 10) -> List[LoopCandidate]:
    """For every ``stride``-th keyframe, the nearest keyframe at least
    ``time_thresh`` seconds older and within ``search_radius`` metres; the
    first ``max_loops`` of them. Host numpy."""
    p = np.asarray(p)
    t = np.asarray(kf_time)
    out = []
    for i in range(0, p.shape[0], stride):
        old_mask = t < t[i] - time_thresh
        if not old_mask.any():
            continue
        d = np.linalg.norm(p[old_mask] - p[i], axis=-1)
        j = np.argmin(d)
        if d[j] < search_radius:
            out.append(LoopCandidate(cur=i, old=int(np.nonzero(old_mask)[0][j])))
    return out[:max_loops]


def _retract(x: Pose, dx):
    return Pose(x.p + dx[:3], quat.normalize(quat.mul(x.q, quat.exp(dx[3:6]))))


def local_map(scans_old, scans_old_valid, p_old, q_old):
    """The local map of ``verify_loop``: scans (W, S, 3) placed by their
    poses (W, 3), (W, 4) in f64 and flattened to f32 (W·S, 3), with
    validity (W·S,)."""
    W, S = scans_old_valid.shape
    world = (quat.rotate(q_old.to(F64)[:, None, :], scans_old.to(F64))
             + p_old.to(F64)[:, None, :]).to(F32)
    return world.reshape(W * S, 3), scans_old_valid.reshape(W * S).contiguous()


def place(scan, p, q):
    """A scan (S, 3) placed at pose (p, q) in f64, as the f32 kNN queries."""
    return (quat.rotate(q.to(F64), scan.to(F64)) + p.to(F64)).to(F32)


def verify_loop(cfg: GlioConfig, scan_cur, scan_cur_valid, scans_old, scans_old_valid,
                p_old, q_old, p_init, q_init):
    """ICP the current scan against a local map around the old keyframe.

    Tensors on one device: scan_cur (S, 3), scan_cur_valid (S,), scans_old
    (W, S, 3) with poses p_old (W, 3), q_old (W, 4), p_init (3,), q_init
    (4,). The scans are placed by the poses directly, without the lidar
    extrinsic, as in the JAX package. Returns (p, q, fitness, accepted):
    the current keyframe's corrected pose, the final point-to-plane RMS and
    whether it passes ``lc_icp_thres``.
    """
    map_flat, mv = local_map(scans_old, scans_old_valid, p_old, q_old)
    scan64 = scan_cur.to(F64)
    sv = scan_cur_valid.contiguous()
    x = Pose(p_init.to(F64), q_init.to(F64))
    fitness = None
    for _ in range(3):  # ICP outer rounds
        world_q = place(scan64, x.p, x.q)
        _, idx = knn(world_q, sv, map_flat, mv, k=5)
        neigh = neighbors.gather_neighbors(map_flat, idx)
        fit = plane_fit.fit_planes(neigh, idx >= 0, world_q, plane_tol=0.1)
        good = fit.valid & sv & (fit.weight > 0.4)
        nrm = fit.normal.to(F64)
        dpl = fit.d.to(F64)

        def residual(s: Pose):
            pw = quat.rotate(s.q, scan64) + s.p
            r = torch.sum(nrm * pw, dim=-1) + dpl
            r = torch.where(good, r, torch.zeros_like(r))
            return r * dense.huber_weight(r, 0.2)

        x = dense.lm_solve(residual, _retract, x, DOF, max_iters=8).x
        n = torch.clamp(good.sum(), min=1)
        r = residual(x)
        fitness = torch.sqrt(torch.sum(r * r) / n)
    accepted = (fitness < cfg.estimator.lc_icp_thres) & (sv.sum() > 50)
    return x.p, x.q, fitness, accepted


def solve_with_loops(p_odo, q_odo, loop_edges: List[Tuple[int, int, np.ndarray, np.ndarray]],
                     w_rel_p=10.0, w_rel_q=100.0, w_loop=10.0, gn_iters: int = 6):
    """Pose-graph solve of the odometry chain plus loop edges.

    p_odo (T, 3), q_odo (T, 4) tensors on the solve's device; loop_edges:
    (i, j, dp, dq), the measured pose of j in i's frame. ``gn_iters``
    undamped Gauss-Newton steps, each by ``banded.woodbury_solve`` (the
    chain's band plus the loop rows). Returns (p, q).
    """
    p, q = p_odo.to(F64), q_odo.to(F64)
    T = p.shape[0]
    dev = p.device
    hw = 1
    rel_dq = quat.mul(quat.conj(q[:-1]), q[1:])
    rel_dp = quat.rotate(quat.conj(q[:-1]), p[1:] - p[:-1])
    plans = chain_plans(T, dev)
    eye = torch.eye(DOF, dtype=F64, device=dev)
    if loop_edges:
        li = torch.as_tensor([e[0] for e in loop_edges], device=dev)
        lj = torch.as_tensor([e[1] for e in loop_edges], device=dev)
        l_dp = torch.as_tensor(np.stack([e[2] for e in loop_edges]), dtype=F64, device=dev)
        l_dq = torch.as_tensor(np.stack([e[3] for e in loop_edges]), dtype=F64, device=dev)
        n_rows = 6 * len(loop_edges)
        row_of = torch.arange(n_rows, device=dev)
    for _ in range(gn_iters):
        band = torch.zeros((T, 2 * hw + 1, DOF, DOF), dtype=F64, device=dev)
        grad = torch.zeros((T, DOF), dtype=F64, device=dev)
        res, Ji, Jj = edge_jacobians(p[:-1], q[:-1], p[1:], q[1:], rel_dp, rel_dq,
                                     w_rel_q, w_rel_p)
        _scatter_pair(band, grad, Ji, Jj, res, plans)
        band[0, hw] += 1e6 * eye                     # anchor pose 0
        band[:, hw] += 1e-6 * eye
        if not loop_edges:
            dx = banded.direct_solve(band, -grad)
        else:
            # Loop rows, dense over the keyframes (few of them).
            res_l, Jli, Jlj = edge_jacobians(p[li], q[li], p[lj], q[lj], l_dp, l_dq,
                                             w_loop * 10, w_loop)
            J_extra = torch.zeros((n_rows, T, DOF), dtype=F64, device=dev)
            J_extra[row_of, li.repeat_interleave(6)] = Jli.reshape(n_rows, DOF)
            J_extra[row_of, lj.repeat_interleave(6)] = Jlj.reshape(n_rows, DOF)
            dx = banded.woodbury_solve(band, -grad, J_extra, res_l.reshape(n_rows))
        p = p + dx[:, :3]
        q = quat.normalize(quat.mul(q, quat.exp(dx[:, 3:6])))
    return p, q
