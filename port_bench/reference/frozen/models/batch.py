"""Batch (global) fusion, levels 0 and 1 (port of ``glio_tpu/models/batch.py``).

The stage that writes ``tc_batch_result.csv``: the whole sliding-window
trajectory is re-solved against the GNSS double differences
(``Estimator::optimizeBatchWithLandMark``, Estimator.cpp:2739-3410):

* 4 outer stages with annealed DD outlier thresholds {1e9, 10, 8, 6};
* relative-attitude factors (weight 10000) and relative-pose factors
  (weights 10 / 20) to the 1..``search_range`` following keyframes, taken
  from the sliding-window trajectory;
* per-epoch DD pseudorange rows over all constellations, bound to the
  keyframe pair that brackets the epoch, whitened as the reference does.

Each stage is a damped Gauss-Newton loop over the block-banded normal
equations: analytic Jacobians, a deterministic scatter into band storage
(``solver.banded``) and an exact f64 solve by block cyclic reduction. The
loop never waits on the host: accept and reject are ``torch.where``s and
the cost is read once per stage. ``build_problem`` and
``calibrate_batch_covariance`` are host numpy, as in the JAX package.

Frozen for the benchmark's reference: only what ``optimize_batch`` runs at
level 0 with the ``direct`` solver and no Doppler rows is kept (the port's
level 1, Doppler rows, zenith-bias chain, PCG solvers, rank ownership and
variants are not copied). Plain f64 throughout.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..gnss import dd as dd_mod
from ..factors.gnss import local_to_ecef, r_ecef_local
from ..solver import banded
from ..utils import quat
from .. import precision as P

POSE_DOF = 6  # level-0 state per keyframe: δp(3), δθ(3)


class BatchProblem(NamedTuple):
    """Measurement tensors of one batch solve, on one device."""
    # Odometry snapshot (the sliding-window trajectory).
    p_odo: torch.Tensor        # (T, 3)
    q_odo: torch.Tensor        # (T, 4)
    # Relative-pose measurements to the following keyframes 1..R.
    rel_dp: torch.Tensor       # (T, R, 3) in frame i
    rel_dq: torch.Tensor       # (T, R, 4)
    rel_valid: torch.Tensor    # (T, R) bool
    # GNSS DD epochs bound to bracketing keyframe pairs (i, i+1).
    ep_left: torch.Tensor      # (E,) int64 keyframe index i
    ep_ratio: torch.Tensor     # (E,) interpolation weight of keyframe i
    ep_valid: torch.Tensor     # (E,) bool
    sat_pos: torch.Tensor      # (E, M, 3)
    psr_rov: torch.Tensor      # (E, M)
    psr_sta: torch.Tensor      # (E, M)
    sv_valid: torch.Tensor     # (E, M) bool
    system: torch.Tensor       # (E, M) int32
    master: torch.Tensor       # (E, 4) int64
    whiten: torch.Tensor       # (E, 4, M, M)
    # Doppler channel (read only by the Doppler rows, ``doppler_in_batch``).
    sat_vel: torch.Tensor      # (E, M, 3)
    sat_ddt: torch.Tensor      # (E, M)
    dopp: torch.Tensor         # (E, M) measured range rate (m/s)
    dopp_sigma: torch.Tensor   # (E, M) sqrt(10·var_elesnr) (Estimator.cpp:2288)
    elevation: torch.Tensor    # (E, M) radians
    kf_dt: torch.Tensor        # () median keyframe spacing
    kf_time: torch.Tensor      # (T,)
    # Georeference, held constant.
    anchor_ecef: torch.Tensor  # (3,)
    yaw_enu_local: torch.Tensor  # ()
    station_ecef: torch.Tensor   # (3,)


def despike_trajectory(p_odo, q_odo, kf_time, vmax: float = 30.0,
                       max_passes: int = 4):
    """Replace isolated implausible poses by interpolating their neighbours.

    A keyframe whose incoming and outgoing hops both exceed ``vmax`` while
    the hop bridging them is plausible is an isolated excursion (the
    reference's tc_sw_result.csv has some of up to ~634 m); a one-shot
    batch solve cannot heal it, so its initialization is repaired. Host
    numpy; returns (p, q, number of poses repaired).
    """
    p = np.array(p_odo, float)
    q = np.array(q_odo, float)
    t = np.asarray(kf_time, float)
    T = p.shape[0]
    max_width = 5
    n_fixed = 0
    for _ in range(max_passes):
        dt = np.maximum(np.diff(t), 1e-3)
        speed = np.linalg.norm(np.diff(p, axis=0), axis=-1) / dt
        bad = np.where(speed > vmax)[0]       # hop k → k+1 implausible
        fixed_this_pass = 0
        used = set()
        for a in bad:
            if a in used:
                continue
            # Excursion = poses a+1..b, entered by hop a and left by hop b,
            # with a plausible bridge a → b+1 across it.
            for b in bad:
                if b < a or b - a > max_width or b in used:
                    continue
                if b + 1 >= T:
                    continue
                bridge = np.linalg.norm(p[b + 1] - p[a]) / max(t[b + 1] - t[a], 1e-3)
                if bridge >= vmax:
                    continue
                for k in range(a + 1, b + 1):
                    w = (t[k] - t[a]) / max(t[b + 1] - t[a], 1e-3)
                    p[k] = (1.0 - w) * p[a] + w * p[b + 1]
                    q[k] = quat.slerp_np(q[a], q[b + 1], w)
                    fixed_this_pass += 1
                used.update(range(a, b + 1))
                break
        # Trailing spike (no exit hop): dead-reckon from the last hop.
        if T >= 3 and np.linalg.norm(p[-1] - p[-2]) / max(t[-1] - t[-2], 1e-3) > vmax:
            p[-1] = p[-2] + (p[-2] - p[-3]) * (
                (t[-1] - t[-2]) / max(t[-2] - t[-3], 1e-3))
            q[-1] = q[-2]
            fixed_this_pass += 1
        n_fixed += fixed_this_pass
        if not fixed_this_pass:
            break
    return p, q, n_fixed


def build_problem(cfg, p_odo, q_odo, kf_time, gnss, anchor_ecef, yaw_enu_local,
                  station_ecef, despike: bool = True, *, device) -> BatchProblem:
    """Host-side problem construction (relative measurements, epoch
    binding, whitening); the result lives on ``device``."""
    est = cfg.estimator
    T = p_odo.shape[0]
    R = est.search_range

    p_odo = np.asarray(p_odo, float)
    q_odo = np.asarray(q_odo, float)
    if despike and T > 2:
        p_odo, q_odo, _ = despike_trajectory(p_odo, q_odo, kf_time)
    qt = torch.as_tensor(q_odo)
    pt = torch.as_tensor(p_odo)

    rel_dp = np.zeros((T, R, 3))
    rel_dq = np.zeros((T, R, 4))
    rel_dq[..., 0] = 1.0
    rel_valid = np.zeros((T, R), bool)
    kf_dt = np.median(np.diff(np.asarray(kf_time, float))) if T > 1 else 0.33
    # Plausibility gate on odometry relatives: drop those implying more
    # than 30 m/s, so a sliding-window divergence spike cannot lock the
    # chain against the GNSS evidence.
    max_speed = 30.0
    for r in range(1, R + 1):
        n = T - r
        qi = qt[:n]
        rel_dq[:n, r - 1] = quat.mul(quat.conj(qi), qt[r:]).numpy()
        rel_dp[:n, r - 1] = quat.rotate(quat.conj(qi), pt[r:] - pt[:n]).numpy()
        speed = np.linalg.norm(rel_dp[:n, r - 1], axis=-1) / (r * kf_dt)
        rel_valid[:n, r - 1] = speed < max_speed

    # Epoch binding: the keyframe pair bracketing each epoch time.
    kf_time = np.asarray(kf_time, float)
    E = gnss.time.shape[0]
    M = gnss.sat_pos.shape[1]
    left = np.searchsorted(kf_time, gnss.time, side="right") - 1
    ep_valid = (left >= 0) & (left < T - 1)
    left_c = np.clip(left, 0, T - 2)
    dt = kf_time[left_c + 1] - kf_time[left_c]
    # ratio multiplies P_left (dd_psr_factor.hpp:42): 1 at the left keyframe.
    ratio = np.where(dt > 0, (kf_time[left_c + 1] - gnss.time) / np.maximum(dt, 1e-9), 0.5)
    ep_valid &= (ratio >= 0.0) & (ratio <= 1.0)

    whiten = np.zeros((E, 4, M, M))
    for k in range(E):
        if ep_valid[k]:
            whiten[k] = dd_mod.dd_whitening_matrix(
                gnss.elevation[k], gnss.snr[k], gnss.valid[k], gnss.system[k],
                gnss.master[k], M)

    var = dd_mod.elesnr_var_np(np.asarray(gnss.elevation, float),
                               np.asarray(gnss.snr, float))
    dopp_sigma = np.sqrt(10.0 * np.maximum(var, 1e-6))

    def f(a):
        return torch.as_tensor(np.asarray(a, float), dtype=P.F64, device=device)

    def i(a, dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    return BatchProblem(
        p_odo=f(p_odo), q_odo=f(q_odo), rel_dp=f(rel_dp), rel_dq=f(rel_dq),
        rel_valid=i(rel_valid, torch.bool),
        ep_left=i(left_c, torch.int64), ep_ratio=f(ratio),
        ep_valid=i(ep_valid, torch.bool),
        sat_pos=f(gnss.sat_pos), psr_rov=f(gnss.psr_rov), psr_sta=f(gnss.psr_sta),
        sv_valid=i(gnss.valid, torch.bool), system=i(gnss.system, torch.int32),
        master=i(gnss.master, torch.int64), whiten=f(whiten),
        sat_vel=f(gnss.sat_vel), sat_ddt=f(gnss.sat_ddt), dopp=f(gnss.dopp_rov),
        dopp_sigma=f(dopp_sigma), elevation=f(gnss.elevation),
        kf_dt=f(float(kf_dt)), kf_time=f(kf_time),
        anchor_ecef=f(anchor_ecef), yaw_enu_local=f(float(yaw_enu_local)),
        station_ecef=f(station_ecef))


# --- residuals -------------------------------------------------------------------

W_ATT = 10000.0   # delta_q_factor_auto weight (LidarKeyframeFactor.h:293)
W_REL_Q = 10.0    # LidarPoseFactorBatchRelativeAutoDiff weights (:76-81)
W_REL_P = 20.0


class RobustOpts(NamedTuple):
    """IRLS weights on top of the reference's ×0.05 scheme, frozen per LM
    iteration at the current iterate: Huber on whitened DD rows, a
    per-epoch whitened-RMS gate (×0.05 beyond it), Huber on the norms of
    the relative-factor rows. 0 turns each off."""
    dd_huber: float = 0.0
    epoch_gate: float = 0.0
    rel_huber: float = 0.0


NO_ROBUST = RobustOpts()


def _check_supported(cfg, solver: str = "direct"):
    if solver != "direct" or cfg.estimator.doppler_in_batch:
        raise ValueError("the frozen batch holds the direct solve without Doppler rows only")


def _rel_rows_raw(p, q, prob: BatchProblem):
    """Unweighted relative-pose and attitude rows, (T, R, 9). The rolled
    pairs that wrap around the end are masked by ``rel_valid``."""
    rows = []
    for r in range(prob.rel_valid.shape[1]):
        qj = torch.roll(q, -(r + 1), dims=0)
        pj = torch.roll(p, -(r + 1), dims=0)
        # delta_q factor: 10000 · vec(Δq⁻¹ qi⁻¹ qj)
        err_q = quat.mul(quat.conj(prob.rel_dq[:, r]),
                         quat.mul(quat.conj(q), qj))[:, 1:]
        # relative-pose factor: 10·2·vec(...), 20·(qi⁻¹(pj − pi) − Δp)
        err_p = quat.rotate(quat.conj(q), pj - p) - prob.rel_dp[:, r]
        row = torch.cat([W_ATT * err_q, W_REL_Q * 2.0 * err_q, W_REL_P * err_p], -1)
        rows.append(torch.where(prob.rel_valid[:, r][:, None], row,
                                torch.zeros_like(row)))
    return torch.stack(rows, dim=1)


def _rel_residuals(p, q, prob, w_rel=None):
    rows = _rel_rows_raw(p, q, prob)
    return rows if w_rel is None else rows * w_rel[..., None]


def _dd_rows_raw(p, prob: BatchProblem, threshold):
    """Unweighted whitened DD rows, (E, 4, M)."""
    left = prob.ep_left
    ratio = prob.ep_ratio[:, None]
    p_local = ratio * p[left] + (1.0 - ratio) * p[left + 1]
    p_ecef = local_to_ecef(p_local, prob.anchor_ecef, prob.yaw_enu_local)
    r = dd_mod.dd_residual(p_ecef, prob.sat_pos, prob.psr_rov, prob.psr_sta,
                           prob.station_ecef, prob.sv_valid, prob.system,
                           prob.master, prob.whiten, threshold)
    return torch.where(prob.ep_valid[:, None, None], r, torch.zeros_like(r))


def _dd_residuals(p, prob, threshold, w_dd=None):
    rows = _dd_rows_raw(p, prob, threshold)
    return rows if w_dd is None else rows * w_dd


def _scalar(value, like):
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _dd_row_jac(p, R_el, prob: BatchProblem, threshold, w, robust=None):
    """Every epoch's whitened DD rows and their ANALYTIC Jacobian w.r.t.
    the interpolated local position (dd_psr_factor.hpp:104-150): the row
    derivative is the whitened line-of-sight difference through R_el.

    Returns (res (E, 4M), JP (E, 4M, 3), wf (E, 4M)). With ``robust`` the
    IRLS weights wf are derived here from the freshly whitened rows;
    otherwise wf = w, reshaped.
    """
    left = prob.ep_left
    ratio = prob.ep_ratio[:, None]
    p_local = ratio * p[left] + (1.0 - ratio) * p[left + 1]
    P = p_local @ R_el.T + prob.anchor_ecef                     # (E, 3)
    d = prob.sat_pos - P[:, None, :]
    rho_u = torch.clamp(torch.linalg.norm(d, dim=-1), min=1.0)
    los = d / rho_u[..., None]                                  # (E, M, 3)
    rho_r = torch.linalg.norm(prob.sat_pos - prob.station_ecef, dim=-1)
    sd_est = rho_u - rho_r
    sd_meas = prob.psr_rov - prob.psr_sta
    idx = torch.arange(sd_est.shape[1], device=p.device)
    res_parts, jac_parts = [], []
    for s in range(prob.master.shape[1]):
        mp = prob.master[:, s:s + 1]
        mp_s = torch.clamp(mp, min=0)
        dd = ((sd_est - sd_est.gather(1, mp_s))
              - (sd_meas - sd_meas.gather(1, mp_s)))
        m = prob.sv_valid & (prob.system == s) & (idx != mp_s) & (mp >= 0)
        r = torch.where(m, dd, torch.zeros_like(dd))
        wth = torch.where(torch.abs(r) > threshold, _scalar(0.05, r), _scalar(1.0, r))
        r = r * wth
        los_m = los.gather(1, mp_s[..., None].expand(-1, 1, 3))
        JrowP = (los_m - los) * (m * wth)[..., None]
        out = prob.whiten[:, s] @ torch.cat([r[..., None], JrowP], -1)    # (E, M, 4)
        res_parts.append(out[..., 0])
        jac_parts.append(out[..., 1:4])
    res = torch.cat(res_parts, dim=1)
    JP_ecef = torch.cat(jac_parts, dim=1)
    valid = prob.ep_valid[:, None]
    if robust is not None:
        w_r = torch.ones_like(res)
        if robust.dd_huber > 0.0:
            w_r = torch.sqrt(torch.clamp(
                robust.dd_huber / torch.clamp(torch.abs(res), min=1e-12), max=1.0))
        if robust.epoch_gate > 0.0:
            nz = torch.abs(res) > 1e-12
            n = torch.clamp(nz.sum(dim=1, keepdim=True), min=1)
            rms = torch.sqrt(torch.sum(res * res, dim=1, keepdim=True) / n)
            # The gate stays absolute across the anneal schedule (JAX
            # package, batch.py:397-403).
            w_r = w_r * torch.where(rms > robust.epoch_gate, _scalar(0.05, rms),
                                    _scalar(1.0, rms))
        wf = torch.where(valid, w_r, torch.ones_like(w_r))
    else:
        wf = w.reshape(res.shape)
    res = torch.where(valid, res * wf, torch.zeros_like(res))
    JP = (JP_ecef * wf[..., None]) @ R_el
    JP = torch.where(valid[..., None], JP, torch.zeros_like(JP))
    return res, JP, wf


def _retract(p, q, dx):
    d = dx.reshape(p.shape[0], POSE_DOF)
    return p + d[:, :3], quat.normalize(quat.mul(q, quat.exp(d[:, 3:6])))


def _half_sq(res):
    """½ Σ res²."""
    return 0.5 * torch.sum(res * res)


def _total_cost(p, q, prob, threshold, w_rel=None, w_dd=None):
    """The cost at (p, q)."""
    return (_half_sq(_rel_residuals(p, q, prob, w_rel))
            + _half_sq(_dd_residuals(p, prob, threshold, w_dd)))


# --- assembly ----------------------------------------------------------------------

class AssemblyPlan(NamedTuple):
    """Scatter targets of one problem's assembly (see ``banded.ScatterPlan``):
    for each relative offset, then for the DD pairs, the plans of the four
    block scatters and the two gradient scatters of the pairs (i, j)."""
    rel: tuple   # per r: (plan_ii, plan_ij, plan_ji, plan_jj, plan_gi, plan_gj)
    dd: tuple    # the same for the DD pairs (k, k+1)


def assembly_plan(prob: BatchProblem, hw: int) -> AssemblyPlan:
    """Made once per problem: reads ``ep_left`` to the host."""
    T = prob.p_odo.shape[0]
    dev = prob.p_odo.device
    i_idx = np.arange(T)
    rel = []
    for r in range(prob.rel_valid.shape[1]):
        # Pairs past the end are clamped to T − 1; their rows are masked.
        j_idx = np.minimum(i_idx + r + 1, T - 1)
        rel.append(pair_plans(i_idx, j_idx, hw, dev))
    k = prob.ep_left.cpu().numpy()
    return AssemblyPlan(tuple(rel), pair_plans(k, k + 1, hw, dev))


def pair_plans(a, b, hw: int, device) -> tuple:
    """The six scatter plans of ``_scatter_pair`` for the pairs (a[n], b[n])
    (host int arrays)."""
    return (banded.block_plan(a, a, hw, device), banded.block_plan(a, b, hw, device),
            banded.block_plan(b, a, hw, device), banded.block_plan(b, b, hw, device),
            banded.scatter_plan(a, device), banded.scatter_plan(b, device))


def _hat(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _scatter_pair(band, grad, Ji, Jj, res, plans):
    """Add one factor family's blocks JiᵀJi, JiᵀJj, JjᵀJi, JjᵀJj and
    gradients Jiᵀr, Jjᵀr at its (i, j) pairs."""
    p_ii, p_ij, p_ji, p_jj, p_gi, p_gj = plans
    blocks = band.view(-1, *band.shape[2:])       # (T·(2hw+1), D, D)
    Hij = torch.einsum("nri,nrj->nij", Ji, Jj)
    banded.scatter_add_rows(blocks, torch.einsum("nri,nrj->nij", Ji, Ji), p_ii)
    banded.scatter_add_rows(blocks, Hij, p_ij)
    banded.scatter_add_rows(blocks, Hij.mT, p_ji)
    banded.scatter_add_rows(blocks, torch.einsum("nri,nrj->nij", Jj, Jj), p_jj)
    banded.scatter_add_rows(grad, torch.einsum("nri,nr->ni", Ji, res), p_gi)
    banded.scatter_add_rows(grad, torch.einsum("nri,nr->ni", Jj, res), p_gj)


def _assemble_core_impl(p, q, prob: BatchProblem, threshold, hw: int,
                        w_rel=None, w_dd=None, robust: RobustOpts = None,
                        plan: AssemblyPlan = None):
    """Band and gradient by analytic per-factor Jacobians, plus the cost at
    (p, q) and the IRLS weights used.

    Returns (band (T, 2hw+1, D, D), grad (T, D), cost, w_rel, w_dd), D = 6.
    With ``robust`` the weights are derived from the rows at (p, q);
    otherwise ``w_rel`` / ``w_dd`` (default ones) are applied.
    """
    T = p.shape[0]
    D = POSE_DOF
    dev = p.device
    if plan is None:
        plan = assembly_plan(prob, hw)
    band = torch.zeros((T, 2 * hw + 1, D, D), dtype=P.F64, device=dev)
    grad = torch.zeros((T, D), dtype=P.F64, device=dev)
    cost = torch.zeros((), dtype=P.F64, device=dev)
    derive_w = robust is not None
    if w_rel is None:
        w_rel = torch.ones(prob.rel_valid.shape, dtype=P.F64, device=dev)
    if w_dd is None:
        w_dd = torch.ones(prob.ep_valid.shape + prob.master.shape[1:]
                          + prob.sv_valid.shape[1:], dtype=P.F64, device=dev)

    # --- relative factors, pairs (i, i+r+1). With the right retraction
    # q ⊞ δ = q ⊗ exp(δ):
    #   e_q = vec(Δq̄⁻¹ ⊗ exp(−δi) ⊗ qi⁻¹qj ⊗ exp(δj))
    #     → ∂e_q/∂δθj = ½·Qleft(Δq̄⁻¹ ⊗ Q)[1:,1:],
    #       ∂e_q/∂δθi = −½·(Qleft(Δq̄⁻¹)·Qright(Q))[1:,1:], Q = qi⁻¹qj;
    #   e_p = Riᵀ(pj − pi) − Δp̄ → ∂/∂pi = −Riᵀ, ∂/∂pj = Riᵀ,
    #       ∂/∂δθi = [Riᵀ(pj − pi)]×.
    w_rel_out = []
    for r, plans in enumerate(plan.rel):
        pj = torch.roll(p, -(r + 1), dims=0)
        qj = torch.roll(q, -(r + 1), dims=0)
        mask = prob.rel_valid[:, r].to(P.F64)
        Mq = quat.conj(prob.rel_dq[:, r])
        Q = quat.mul(quat.conj(q), qj)
        MQ = quat.mul(Mq, Q)
        RiT = quat.to_rotmat(quat.conj(q))                 # (T, 3, 3)
        Rd = torch.einsum("tij,tj->ti", RiT, pj - p)
        res_raw = torch.cat([W_ATT * MQ[:, 1:], W_REL_Q * 2.0 * MQ[:, 1:],
                             W_REL_P * (Rd - prob.rel_dp[:, r])], -1) * mask[:, None]
        if derive_w:
            if robust.rel_huber > 0.0:
                nrm = torch.linalg.norm(res_raw, dim=-1)
                wr = torch.sqrt(torch.clamp(
                    robust.rel_huber / torch.clamp(nrm, min=1e-12), max=1.0))
            else:
                wr = torch.ones((T,), dtype=P.F64, device=dev)
            w_rel_out.append(wr)
        else:
            wr = w_rel[:, r]
        mw = (mask * wr)[:, None, None]
        res = res_raw * wr[:, None]
        cost = cost + _half_sq(res)

        JqjR = 0.5 * quat.qleft(MQ)[:, 1:, 1:]
        JqiR = -0.5 * (quat.qleft(Mq) @ quat.qright(Q))[:, 1:, 1:]
        Ji = torch.zeros((T, 9, D), dtype=P.F64, device=dev)
        Ji[:, 0:3, 3:6] = W_ATT * JqiR
        Ji[:, 3:6, 3:6] = W_REL_Q * 2.0 * JqiR
        Ji[:, 6:9, 0:3] = -W_REL_P * RiT
        Ji[:, 6:9, 3:6] = W_REL_P * _hat(Rd)
        Jj = torch.zeros((T, 9, D), dtype=P.F64, device=dev)
        Jj[:, 0:3, 3:6] = W_ATT * JqjR
        Jj[:, 3:6, 3:6] = W_REL_Q * 2.0 * JqjR
        Jj[:, 6:9, 0:3] = W_REL_P * RiT
        _scatter_pair(band, grad, Ji * mw, Jj * mw, res, plans)
    w_rel_all = torch.stack(w_rel_out, dim=1) if derive_w and w_rel_out else w_rel

    res, w_dd_rows = _scatter_dd(band, grad, p, prob, threshold, w_dd, robust, plan.dd)
    cost = cost + _half_sq(res)
    w_dd_all = w_dd_rows.reshape(w_dd.shape) if derive_w else w_dd
    return band, grad, cost, w_rel_all, w_dd_all


def _scatter_dd(band, grad, p, prob: BatchProblem, threshold, w_dd, robust, plans):
    """The DD factors, pairs (k, k+1), positions only, into (band, grad);
    returns their rows and IRLS weights."""
    D = band.shape[-1]
    R_el = r_ecef_local(prob.anchor_ecef, prob.yaw_enu_local)
    res, JP, w_dd_rows = _dd_row_jac(p, R_el, prob, threshold, w_dd, robust)
    # ∂p_local/∂p_k = ratio·I, ∂/∂p_k+1 = (1 − ratio)·I.
    ratio = prob.ep_ratio[:, None, None]
    Ji = torch.zeros(res.shape + (D,), dtype=P.F64, device=p.device)
    Ji[..., :3] = JP * ratio
    Jj = torch.zeros_like(Ji)
    Jj[..., :3] = JP * (1.0 - ratio)
    _scatter_pair(band, grad, Ji, Jj, res, plans)
    return res, w_dd_rows


# --- solves ------------------------------------------------------------------------

def _damp(band, lam, hw: int):
    """Levenberg damping of the diagonal blocks, in place."""
    D = band.shape[-1]
    eye = torch.eye(D, dtype=P.F64, device=band.device)
    diag = band[:, hw]
    band[:, hw] = diag + lam * (
        eye * torch.clamp(torch.diagonal(diag, dim1=-2, dim2=-1), min=1.0)[..., None, :] * eye)


def solve_batch_once(cfg, prob: BatchProblem, p0, q0, threshold,
                     lm_iters: int = 10, robust: RobustOpts = NO_ROBUST,
                     plan: AssemblyPlan = None):
    """One annealing stage: ``lm_iters`` damped Gauss-Newton iterations,
    each step solved exactly by block cyclic reduction. ``robust``
    re-derives the IRLS weights at the current iterate every iteration; the
    step is accepted when the cost under those same frozen weights drops.
    Nothing here waits on the host. Returns (p, q, unweighted cost) as
    tensors.
    """
    hw = cfg.estimator.search_range + 1
    if plan is None:
        plan = assembly_plan(prob, hw)
    p, q = _lm_stage(
        p0, q0, lm_iters, hw,
        lambda p, q: _assemble_core_impl(p, q, prob, threshold, hw, robust=robust, plan=plan),
        lambda band, grad: banded.cyclic_reduction_solve(band, -grad),
        lambda p, q, w_rel, w_dd: _total_cost(p, q, prob, threshold, w_rel, w_dd))
    return p, q, _total_cost(p, q, prob, threshold)


def _lm_stage(p0, q0, lm_iters: int, hw: int, assemble, step, trial_cost, agree=None):
    """``lm_iters`` damped Gauss-Newton iterations: ``assemble(p, q)`` →
    (band, grad, cost, w_rel, w_dd), ``step(band, grad)`` → the step,
    ``trial_cost(p, q, w_rel, w_dd)`` → the trial point's cost under the
    frozen weights (``agree``: the port's signature; unused here).
    Returns (p, q)."""
    p, q = p0, q0
    lam = torch.tensor(1e-4, dtype=P.F64, device=p0.device)
    for _ in range(lm_iters):
        band, grad, cost_cur, w_rel, w_dd = assemble(p, q)
        _damp(band, lam, hw)
        p_new, q_new = _retract(p, q, step(band, grad).reshape(-1))
        new_cost = trial_cost(p_new, q_new, w_rel, w_dd)
        better = new_cost < cost_cur
        p = torch.where(better, p_new, p)
        q = torch.where(better, q_new, q)
        lam = torch.clamp(torch.where(better, lam * 0.3, lam * 5.0), 1e-9, 1e6)
    return p, q


def optimize_batch(cfg, prob: BatchProblem, thresholds=(1e9, 10.0, 8.0, 6.0),
                   lm_iters=10, solver: str = "direct",
                   robust: RobustOpts = NO_ROBUST, init=None, plan: AssemblyPlan = None):
    """The annealed batch solve (Estimator.cpp:2764-2767), one stage per
    threshold. ``lm_iters``: one count, or one per stage. ``init``: an
    optional (p0, q0) warm start in place of the odometry. ``plan``: the
    problem's ``assembly_plan``, when the caller has it (it depends on the
    epochs' binding only). Returns (p, q, per-stage costs); the cost is read
    to the host once per stage.
    """
    _check_supported(cfg, solver)
    if plan is None:
        plan = assembly_plan(prob, cfg.estimator.search_range + 1)
    p, q = (prob.p_odo, prob.q_odo) if init is None else init
    if isinstance(lm_iters, int):
        lm_iters = (lm_iters,) * len(thresholds)
    costs = []
    for th, iters in zip(thresholds, lm_iters):
        p, q, cost = solve_batch_once(cfg, prob, p, q, th, iters, robust, plan)
        costs.append(float(cost))
    return p, q, costs
