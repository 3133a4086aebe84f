"""Loosely-coupled GNSS/LIO pose-graph fusion (port of ``glio_tpu/models/lc_fusion.py:36-199``).

Stage 3, the reference's GTSAM backend (Estimator.cpp:1915-2043,
4561-4581) that writes ``lc_result.csv``: a prior on the first pose,
between-factors from the sliding-window odometry and GNSS position factors
from RTK fixes that passed the covariance gate and lie at least 5 m apart.
The chain's normal equations are block-tridiagonal (hw = 1); each of a
fixed number of damped Gauss-Newton iterations assembles them with
deterministic scatters (``banded.scatter_add_rows`` on a plan made once on
the host), solves them exactly by block cyclic reduction and accepts or
rejects the step on the device, so the solve never waits on the host.
``build_problem`` (with its spacing gate) is a host loop, as in JAX.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..solver import banded
from ..utils import quat
from .batch import _scatter_pair, pair_plans

F64 = torch.float64
DOF = 6


class LcProblem(NamedTuple):
    rel_dp: torch.Tensor      # (T-1, 3) odometry between i and i+1, frame i
    rel_dq: torch.Tensor      # (T-1, 4)
    w_rel_p: float            # translation weight (1/σ)
    w_rel_q: float            # rotation weight
    gnss_p: torch.Tensor      # (T, 3) fixes in the local frame
    gnss_valid: torch.Tensor  # (T,) bool
    w_gnss: torch.Tensor      # (T,) per-fix weight (1/σ)
    p0: torch.Tensor          # (3,) prior on pose 0
    q0: torch.Tensor          # (4,)


def build_problem(p_odo, q_odo, gnss_p, gnss_valid, gnss_sigma, rel_sigma_p=0.1,
                  rel_sigma_q=0.01, min_spacing_m: float = 5.0, *, device) -> LcProblem:
    """Host-side construction with the reference's gate: a GNSS factor only
    where the fix lies ≥ ``min_spacing_m`` from the last one kept
    (Estimator.cpp:1939-1960). The result lives on ``device``."""
    p_odo = np.asarray(p_odo, float)
    q_odo = np.asarray(q_odo, float)
    T = p_odo.shape[0]
    qt = torch.as_tensor(q_odo)
    dq = quat.mul(quat.conj(qt[:-1]), qt[1:])
    dp = quat.rotate(quat.conj(qt[:-1]), torch.as_tensor(p_odo[1:] - p_odo[:-1]))

    gnss_valid = np.asarray(gnss_valid, bool).copy()
    gnss_p = np.asarray(gnss_p, float)
    last = None
    for k in range(T):
        if not gnss_valid[k]:
            continue
        if last is not None and np.linalg.norm(gnss_p[k] - gnss_p[last]) < min_spacing_m:
            gnss_valid[k] = False
        else:
            last = k

    sigma = np.asarray(gnss_sigma, float)
    w_g = np.where(sigma > 0, 1.0 / np.maximum(sigma, 1e-3), 0.0)

    def f(a):
        return torch.as_tensor(np.asarray(a, float), dtype=F64, device=device)

    return LcProblem(rel_dp=f(dp), rel_dq=f(dq), w_rel_p=1.0 / rel_sigma_p,
                     w_rel_q=1.0 / rel_sigma_q, gnss_p=f(gnss_p),
                     gnss_valid=torch.as_tensor(gnss_valid, device=device), w_gnss=f(w_g),
                     p0=f(p_odo[0]), q0=f(q_odo[0]))


def edge_residuals(pi, qi, pj, qj, dpm, dqm, w_q, w_p):
    """Between-factor rows (N, 6) of pose pairs (i, j) against measured
    relatives (dpm, dqm): w_q·2·vec(Δq̄⁻¹ qi⁻¹ qj), w_p·(Riᵀ(pj − pi) − Δp̄)."""
    rq = w_q * 2.0 * quat.mul(quat.conj(dqm), quat.mul(quat.conj(qi), qj))[..., 1:]
    rp = w_p * (quat.rotate(quat.conj(qi), pj - pi) - dpm)
    return torch.cat([rq, rp], dim=-1)


def edge_jacobians(pi, qi, pj, qj, dpm, dqm, w_q, w_p):
    """Rows and Jacobians of ``edge_residuals`` with respect to the tangents
    (δp, δθ) of pose i and of pose j, retracted as (p + δp, q ⊗ exp(δθ)):
    one forward-mode pass over a 12-vector added to every pair at once
    (each pair's rows depend on its own poses only). Returns res (N, 6),
    Ji (N, 6, 6), Jj (N, 6, 6)."""
    def rows(d):
        return edge_residuals(pi + d[:3], quat.mul(qi, quat.exp(d[3:6])),
                              pj + d[6:9], quat.mul(qj, quat.exp(d[9:12])),
                              dpm, dqm, w_q, w_p)

    zero = torch.zeros(2 * DOF, dtype=pi.dtype, device=pi.device)
    J = torch.func.jacfwd(rows)(zero)
    return rows(zero), J[..., :DOF], J[..., DOF:]


def _gnss_irls(p, prob: LcProblem, huber: float):
    """Sqrt-Huber IRLS weights on the whitened GNSS fix norms, frozen per
    linearization: guards the chain against gross fixes that passed the
    covariance gate."""
    nrm = prob.w_gnss * torch.linalg.norm(p - prob.gnss_p, dim=-1)
    w = torch.sqrt(torch.clamp(huber / torch.clamp(nrm, min=1e-9), max=1.0))
    return torch.where(prob.gnss_valid, w, torch.ones_like(w)).detach()


def _residual_cost(p, q, prob: LcProblem, w_irls=None):
    r_rel = edge_residuals(p[:-1], q[:-1], p[1:], q[1:], prob.rel_dp, prob.rel_dq,
                           prob.w_rel_q, prob.w_rel_p)
    wg = prob.w_gnss if w_irls is None else prob.w_gnss * w_irls
    r_g = wg[:, None] * torch.where(prob.gnss_valid[:, None], p - prob.gnss_p,
                                    torch.zeros_like(p))
    r_prior = 1e3 * torch.cat([p[0] - prob.p0, quat.log(quat.mul(quat.conj(prob.q0), q[0]))])
    return 0.5 * (torch.sum(r_rel[:, :3] ** 2) + torch.sum(r_rel[:, 3:] ** 2)
                  + torch.sum(r_g ** 2) + torch.sum(r_prior ** 2))


def chain_plans(T: int, device):
    """Scatter plans of the chain's pairs (i, i + 1) at hw = 1."""
    i_idx = np.arange(T - 1)
    return pair_plans(i_idx, i_idx + 1, 1, device)


def _assemble(p, q, prob: LcProblem, w_irls=None, plans=None):
    """Band (T, 3, 6, 6) and gradient (T, 6) of the chain, the GNSS unary
    factors and the prior on pose 0."""
    T = p.shape[0]
    hw = 1
    if plans is None:
        plans = chain_plans(T, p.device)
    band = torch.zeros((T, 2 * hw + 1, DOF, DOF), dtype=F64, device=p.device)
    grad = torch.zeros((T, DOF), dtype=F64, device=p.device)
    res, Ji, Jj = edge_jacobians(p[:-1], q[:-1], p[1:], q[1:], prob.rel_dp, prob.rel_dq,
                                 prob.w_rel_q, prob.w_rel_p)
    _scatter_pair(band, grad, Ji, Jj, res, plans)

    # GNSS unary factors (position only).
    w = torch.where(prob.gnss_valid, prob.w_gnss, torch.zeros_like(prob.w_gnss))
    if w_irls is not None:
        w = w * w_irls
    eye3 = torch.eye(3, dtype=F64, device=p.device)
    band[:, hw, :3, :3] += (w ** 2)[:, None, None] * eye3
    grad[:, :3] += w[:, None] * (w[:, None] * (p - prob.gnss_p))

    # Prior on pose 0.
    band[0, hw] += 1e6 * torch.eye(DOF, dtype=F64, device=p.device)
    dq0 = quat.log(quat.mul(quat.conj(prob.q0), q[0]))
    grad[0] += 1e6 * torch.cat([p[0] - prob.p0, dq0])
    return band, grad


def solve(prob: LcProblem, p0, q0, gn_iters: int = 8, gnss_huber: float = 0.0):
    """Damped Gauss-Newton over the chain, ``gn_iters`` iterations with
    accept/reject on the device. Returns (p, q, cost)."""
    T = p0.shape[0]
    plans = chain_plans(T, p0.device)
    eye = torch.eye(DOF, dtype=F64, device=p0.device)
    p, q = p0, q0
    lam = torch.tensor(1e-6, dtype=F64, device=p0.device)
    cost = _residual_cost(p, q, prob)
    for _ in range(gn_iters):
        w_irls = _gnss_irls(p, prob, gnss_huber) if gnss_huber > 0.0 else None
        band, grad = _assemble(p, q, prob, w_irls, plans)
        diag = band[:, 1]
        band[:, 1] = diag + lam * eye * torch.clamp(
            torch.diagonal(diag, dim1=-2, dim2=-1), min=1.0)[..., :, None]
        # The chain (hw = 1) is block-tridiagonal: cyclic reduction's own case.
        d = banded.cyclic_reduction_solve(band, -grad)
        p_new = p + d[:, :3]
        q_new = quat.normalize(quat.mul(q, quat.exp(d[:, 3:6])))
        new_cost = _residual_cost(p_new, q_new, prob, w_irls)
        cost_cur = _residual_cost(p, q, prob, w_irls)
        better = new_cost < cost_cur
        p = torch.where(better, p_new, p)
        q = torch.where(better, q_new, q)
        cost = torch.where(better, new_cost, cost_cur)
        lam = torch.clamp(torch.where(better, lam * 0.3, lam * 5.0), 1e-9, 1e6)
    return p, q, cost
