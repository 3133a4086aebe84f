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
(``solver.banded``) and an exact f64 solve by block cyclic reduction. Every
solver of this module runs the one loop, ``_lm_loop``, stage after stage in
the one annealing loop, ``_anneal``, with the same spans. The loop never
waits on the host: accept and reject are ``torch.where``s and the cost is
read once per stage. On a CUDA device the level-0 stage runs each
iteration's assembly, step and trial cost as the replays of CUDA graphs
(``lm_closures``). ``build_problem`` and ``calibrate_batch_covariance`` are
host numpy, as in the JAX package.

Level 1 (``sms_fusion_level=1``, at the end of this module) replaces the
relative-pose rows by binary point-to-plane factors between keyframes i and
i + 1..R, associated on the device by the 5-NN kernel over all keyframe
pairs at once (``build_sms1``), and adds IMU chains over 15-dof keyframe
states (``build_imu_chain``, ``optimize_batch_sms1_imu``).

With ``doppler_in_batch`` level 0 adds the Doppler rows (``_dopp_residuals``:
velocities by central differences of the pose chain over the real keyframe
intervals, the receiver clock drift eliminated per epoch), which couple the
translations of four consecutive keyframes. ``solver="chol_pcg"`` solves each
step by CG preconditioned with an f32 banded Cholesky factor
(``banded.pcg_chol_solve``), as the JAX package's.

Plain f64 otherwise: the JAX package's ``mixed=True`` (f32 whitening and
Jacobians for the TPU's emulated f64) is not ported. Level 1 takes the same
three solvers (``chol_pcg`` factors its 15-dof band).

The variants: ``optimize_batch_atm`` adds a Gauss-Markov zenith-bias chain,
one more state per keyframe (7×7 blocks); ``optimize_batch_reference_cadence``
re-solves the growing prefix every 10 keyframes as the reference's
backendFusionThread does, and ``optimize_batch_incremental`` every ``every``
keyframes with the relatives re-derived from the corrected trajectory; both
keep one problem shape and mask the prefix. ``optimize_batch_sharded`` runs the
level-0 solve over the ranks of a ``torch.distributed`` process group.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from ..gnss import dd as dd_mod
from ..factors.gnss import local_to_ecef, r_ecef_local
from ..solver import banded
from ..utils import profiling, quat
from ..utils.checkpoint import _leaves, cloned

F64 = torch.float64
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
    with profiling.span("batch.build"):
        return _build_problem(cfg, p_odo, q_odo, kf_time, gnss, anchor_ecef, yaw_enu_local,
                              station_ecef, despike, device)


def _build_problem(cfg, p_odo, q_odo, kf_time, gnss, anchor_ecef, yaw_enu_local,
                   station_ecef, despike, device) -> BatchProblem:
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
        return torch.as_tensor(np.asarray(a, float), dtype=F64, device=device)

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


def _check_solver(solver: str):
    if solver not in ("direct", "pcg", "chol_pcg"):
        raise ValueError(f"unknown batch solver {solver!r}")


def _check_supported(cfg, solver: str = "direct"):
    _check_solver(solver)
    if cfg.estimator.doppler_in_batch and cfg.estimator.search_range + 1 < 3:
        # The Doppler rows couple keyframes li−1 .. li+2: 3 block rows apart.
        raise ValueError("doppler_in_batch needs search_range >= 2 (band half-width 3)")


def _rel_residuals(p, q, prob: BatchProblem, w_rel=None):
    """Relative-pose and attitude rows, (T, R, 9), each times its ``w_rel``
    where given. The rolled pairs that wrap around the end are masked by
    ``rel_valid``."""
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
    rows = torch.stack(rows, dim=1)
    return rows if w_rel is None else rows * w_rel[..., None]


def _dd_residuals(p, prob: BatchProblem, threshold, w_dd=None):
    """Whitened DD rows, (E, 4, M), times ``w_dd`` where given."""
    left = prob.ep_left
    ratio = prob.ep_ratio[:, None]
    p_local = ratio * p[left] + (1.0 - ratio) * p[left + 1]
    p_ecef = local_to_ecef(p_local, prob.anchor_ecef, prob.yaw_enu_local)
    r = dd_mod.dd_residual(p_ecef, prob.sat_pos, prob.psr_rov, prob.psr_sta,
                           prob.station_ecef, prob.sv_valid, prob.system,
                           prob.master, prob.whiten, threshold)
    rows = torch.where(prob.ep_valid[:, None, None], r, torch.zeros_like(r))
    return rows if w_dd is None else rows * w_dd


def _scalar(value, like):
    """``value`` as a 0-d tensor of ``like``'s dtype and device, by a fill on
    the device: a copy from the host could not be captured in a CUDA graph."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _dd_row_jac(p, R_el, prob: BatchProblem, threshold, w, robust=None, z=None):
    """Every epoch's whitened DD rows and their ANALYTIC Jacobian w.r.t.
    the interpolated local position (dd_psr_factor.hpp:104-150): the row
    derivative is the whitened line-of-sight difference through R_el.

    Returns (res (E, 4M), JP (E, 4M, 3), wf (E, 4M)). With ``robust`` the
    IRLS weights wf are derived here from the freshly whitened rows;
    otherwise wf = w, reshaped. With ``z`` (T,), the zenith biases of the
    Gauss-Markov chain, each row gains (mf_i − mf_m)·z at the epoch
    (mf = 1/sin(el): the rover-side atmosphere a synthesized station cannot
    cancel), and a fourth output, the rows' whitened derivative Jz (E, 4M)
    w.r.t. that interpolated z.
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
    if z is not None:
        z_interp = ratio * z[left][:, None] + (1.0 - ratio) * z[left + 1][:, None]
        mf = 1.0 / torch.clamp(torch.sin(prob.elevation), min=0.05)
    res_parts, jac_parts, jz_parts = [], [], []
    for s in range(prob.master.shape[1]):
        mp = prob.master[:, s:s + 1]
        mp_s = torch.clamp(mp, min=0)
        dd = ((sd_est - sd_est.gather(1, mp_s))
              - (sd_meas - sd_meas.gather(1, mp_s)))
        m = prob.sv_valid & (prob.system == s) & (idx != mp_s) & (mp >= 0)
        if z is not None:
            mf_diff = torch.where(m, mf - mf.gather(1, mp_s), torch.zeros_like(mf))
            dd = dd + mf_diff * z_interp
        r = torch.where(m, dd, torch.zeros_like(dd))
        wth = torch.where(torch.abs(r) > threshold, _scalar(0.05, r), _scalar(1.0, r))
        r = r * wth
        los_m = los.gather(1, mp_s[..., None].expand(-1, 1, 3))
        JrowP = (los_m - los) * (m * wth)[..., None]
        cols = [r[..., None], JrowP]
        if z is not None:
            cols.append((mf_diff * wth)[..., None])
        out = prob.whiten[:, s] @ torch.cat(cols, -1)    # (E, M, 4), or 5 with z
        res_parts.append(out[..., 0])
        jac_parts.append(out[..., 1:4])
        if z is not None:
            jz_parts.append(out[..., 4])
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
    if z is not None:
        Jz = torch.cat(jz_parts, dim=1) * wf
        return res, JP, wf, torch.where(valid, Jz, torch.zeros_like(Jz))
    return res, JP, wf


def _retract(p, q, dx):
    d = dx.reshape(p.shape[0], POSE_DOF)
    return p + d[:, :3], quat.normalize(quat.mul(q, quat.exp(d[:, 3:6])))


def _half_sq(res, own=None):
    """½ Σ res², each leading-axis row of ``res`` times its entry of ``own``
    (a 0 / 1 mask of the factors a rank owns) where given."""
    sq = res * res
    if own is not None:
        sq = sq * own.reshape(own.shape + (1,) * (res.dim() - 1))
    return 0.5 * torch.sum(sq)


def _total_cost(p, q, prob, threshold, w_rel=None, w_dd=None, use_doppler: bool = False,
                own=None):
    """The cost at (p, q); with ``own`` = (relative rows (T,), epochs (E,)),
    the ownership masks of a rank-local problem, only the owned factors'."""
    own_rel, own_ep = (None, None) if own is None else own
    c = (_half_sq(_rel_residuals(p, q, prob, w_rel), own_rel)
         + _half_sq(_dd_residuals(p, prob, threshold, w_dd), own_ep))
    if use_doppler:
        c = c + _half_sq(_dopp_residuals(p, prob), own_ep)
    return c


# --- Doppler rows (doppler_in_batch; the reference ships them compiled out) -------

def _dopp_pose_index(prob: BatchProblem, T: int):
    """(E, 4) the keyframes li−1, li, li+1, li+2 of each epoch's Doppler
    rows, clamped into the trajectory."""
    li = prob.ep_left
    return torch.stack([torch.clamp(li - 1, min=0), li, li + 1,
                        torch.clamp(li + 2, max=T - 1)], dim=1)


def _dopp_rows(P4, prob: BatchProblem, idx4):
    """Whitened Doppler rows (E, M) from each epoch's four poses P4 (E, 4, 3)
    (li−1, li, li+1, li+2); see ``_dopp_residuals``."""
    R = r_ecef_local(prob.anchor_ecef, prob.yaw_enu_local)
    kt = prob.kf_time[idx4]
    dt_i = torch.clamp(kt[:, 2] - kt[:, 0], min=1e-3)[:, None]
    dt_j = torch.clamp(kt[:, 3] - kt[:, 1], min=1e-3)[:, None]
    v_i = (P4[:, 2] - P4[:, 0]) / dt_i
    v_j = (P4[:, 3] - P4[:, 1]) / dt_j
    ratio = prob.ep_ratio[:, None]
    p_local = ratio * P4[:, 1] + (1.0 - ratio) * P4[:, 2]
    v_local = ratio * v_i + (1.0 - ratio) * v_j
    P = (p_local @ R.T + prob.anchor_ecef)[:, None, :]
    V = (v_local @ R.T)[:, None, :]
    sp, sv = prob.sat_pos, prob.sat_vel
    d = sp - P
    los = d / torch.clamp(torch.linalg.norm(d, dim=-1), min=1.0)[..., None]
    sagnac = 7.2921151467e-5 / 299792458.0 * (
        sv[..., 0] * P[..., 1] + sp[..., 0] * V[..., 1]
        - sv[..., 1] * P[..., 0] - sp[..., 1] * V[..., 0])
    est = torch.sum((sv - V) * los, dim=-1) + sagnac - prob.sat_ddt
    a = est - prob.dopp                       # the residual before + rcv_ddt
    w = prob.sv_valid.to(a.dtype) / torch.clamp(prob.dopp_sigma, min=1e-3)
    w2 = torch.clamp(torch.sum(w * w, dim=-1, keepdim=True), min=1e-12)
    ddt_opt = -torch.sum(w * w * a, dim=-1, keepdim=True) / w2   # exact weighted elimination
    r = (a + ddt_opt) * w
    return torch.where(prob.ep_valid[:, None], r, torch.zeros_like(r))


def _dopp_residuals(p, prob: BatchProblem):
    """Per-epoch Doppler rows (E, M) with the receiver clock drift
    eliminated (the JAX package's ``_dopp_residuals``): the reference's
    tcdopplerFactor (dopp_factor.hpp:19-85) over velocities from central
    differences of the pose chain across the real keyframe intervals
    (``kf_time``), the drift — a scalar in every row of its epoch —
    projected out in closed form under the rows' weights, so no per-epoch
    state enters the solver. Whitened by the reference's per-satellite
    sigma √(10·var_elesnr) (``dopp_sigma``, Estimator.cpp:71,2288)."""
    idx4 = _dopp_pose_index(prob, p.shape[0])
    return _dopp_rows(p[idx4], prob, idx4)


def _dopp_row_jac(p, prob: BatchProblem):
    """The Doppler rows (E, M), their Jacobian (E, M, 4, 3) w.r.t. the
    translations of poses li−1 .. li+2 by forward mode, and those poses
    (E, 4). Where two of the four indices coincide (clamped at the ends of
    the chain) one delta moves both, as a scatter-add of the deltas does."""
    idx4 = _dopp_pose_index(prob, p.shape[0])
    P4 = p[idx4]
    alias = (idx4[:, :, None] == idx4[:, None, :]).to(p.dtype)      # (E, 4, 4)

    def rows(d4):
        return _dopp_rows(P4 + torch.einsum("eab,bk->eak", alias, d4), prob, idx4)

    zero = torch.zeros((4, 3), dtype=p.dtype, device=p.device)
    return rows(zero), torch.func.jacfwd(rows)(zero), idx4


# --- assembly ----------------------------------------------------------------------

class AssemblyPlan(NamedTuple):
    """Scatter targets of one problem's assembly (see ``banded.ScatterPlan``):
    for each relative offset, then for the DD pairs, the plans of the four
    block scatters and the two gradient scatters of the pairs (i, j); for
    the Doppler rows, the 16 block couplings and 4 gradient rows of each
    epoch's poses li−1 .. li+2 in one plan each (None without them)."""
    rel: tuple   # per r: (plan_ii, plan_ij, plan_ji, plan_jj, plan_gi, plan_gj)
    dd: tuple    # the same for the DD pairs (k, k+1)
    dopp: tuple = None   # (plan of the blocks, plan of the gradient rows)


def assembly_plan(prob: BatchProblem, hw: int, use_doppler: bool = False) -> AssemblyPlan:
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
    dopp = None
    if use_doppler:
        idx4 = _dopp_pose_index(prob, T).cpu().numpy()            # (E, 4)
        # Order a-major, b, then epoch: the JAX package's 16 scatters.
        rows = np.concatenate([idx4[:, a] for a in range(4) for _ in range(4)])
        cols = np.concatenate([idx4[:, b] for _ in range(4) for b in range(4)])
        dopp = (banded.block_plan(rows, cols, hw, dev),
                banded.scatter_plan(idx4.T.reshape(-1), dev))
    return AssemblyPlan(tuple(rel), pair_plans(k, k + 1, hw, dev), dopp)


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
                        plan: AssemblyPlan = None, use_doppler: bool = False, z=None,
                        own=None):
    """Band and gradient by analytic per-factor Jacobians, plus the cost at
    (p, q) and the IRLS weights used.

    Returns (band (T, 2hw+1, D, D), grad (T, D), cost, w_rel, w_dd), D = 6;
    with ``z`` (T,), the zenith biases of ``optimize_batch_atm``, D = 7 and
    the DD rows carry their z column (the Gauss-Markov rows are the
    caller's). With ``robust`` the weights are derived from the rows at (p,
    q); otherwise ``w_rel`` / ``w_dd`` (default ones) are applied. With
    ``own`` (``_total_cost``'s masks) the cost counts only the owned factors.
    """
    T = p.shape[0]
    own_rel, own_ep = (None, None) if own is None else own
    D = POSE_DOF + (z is not None)
    dev = p.device
    if plan is None or (use_doppler and plan.dopp is None):
        plan = assembly_plan(prob, hw, use_doppler)
    band = torch.zeros((T, 2 * hw + 1, D, D), dtype=F64, device=dev)
    grad = torch.zeros((T, D), dtype=F64, device=dev)
    cost = torch.zeros((), dtype=F64, device=dev)
    derive_w = robust is not None
    if w_rel is None:
        w_rel = torch.ones(prob.rel_valid.shape, dtype=F64, device=dev)
    if w_dd is None:
        w_dd = torch.ones(prob.ep_valid.shape + prob.master.shape[1:]
                          + prob.sv_valid.shape[1:], dtype=F64, device=dev)

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
        mask = prob.rel_valid[:, r].to(F64)
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
                wr = torch.ones((T,), dtype=F64, device=dev)
            w_rel_out.append(wr)
        else:
            wr = w_rel[:, r]
        mw = (mask * wr)[:, None, None]
        res = res_raw * wr[:, None]
        cost = cost + _half_sq(res, own_rel)

        JqjR = 0.5 * quat.qleft(MQ)[:, 1:, 1:]
        JqiR = -0.5 * (quat.qleft(Mq) @ quat.qright(Q))[:, 1:, 1:]
        Ji = torch.zeros((T, 9, D), dtype=F64, device=dev)
        Ji[:, 0:3, 3:6] = W_ATT * JqiR
        Ji[:, 3:6, 3:6] = W_REL_Q * 2.0 * JqiR
        Ji[:, 6:9, 0:3] = -W_REL_P * RiT
        Ji[:, 6:9, 3:6] = W_REL_P * _hat(Rd)
        Jj = torch.zeros((T, 9, D), dtype=F64, device=dev)
        Jj[:, 0:3, 3:6] = W_ATT * JqjR
        Jj[:, 3:6, 3:6] = W_REL_Q * 2.0 * JqjR
        Jj[:, 6:9, 0:3] = W_REL_P * RiT
        _scatter_pair(band, grad, Ji * mw, Jj * mw, res, plans)
    w_rel_all = torch.stack(w_rel_out, dim=1) if derive_w and w_rel_out else w_rel

    res, w_dd_rows = _scatter_dd(band, grad, p, prob, threshold, w_dd, robust, plan.dd, z)
    cost = cost + _half_sq(res, own_ep)
    w_dd_all = w_dd_rows.reshape(w_dd.shape) if derive_w else w_dd
    if use_doppler:
        cost = cost + _scatter_dopp(band, grad, p, prob, plan.dopp, own_ep)
    return band, grad, cost, w_rel_all, w_dd_all


def _scatter_dopp(band, grad, p, prob: BatchProblem, plans, own_ep=None):
    """The Doppler rows into the translation corner of the 16 block
    couplings of poses li−1 .. li+2 and their gradients; returns their cost
    (the owned epochs' where ``own_ep`` is given)."""
    D = band.shape[-1]
    res, J4, _ = _dopp_row_jac(p, prob)                    # (E, M), (E, M, 4, 3)
    E = res.shape[0]
    H = torch.einsum("emai,embj->abeij", J4, J4).reshape(16 * E, 3, 3)
    blocks = torch.zeros((16 * E, D, D), dtype=F64, device=p.device)
    blocks[:, :3, :3] = H
    banded.scatter_add_rows(band.view(-1, D, D), blocks, plans[0])
    g = torch.zeros((4 * E, D), dtype=F64, device=p.device)
    g[:, :3] = torch.einsum("emai,em->aei", J4, res).reshape(4 * E, 3)
    banded.scatter_add_rows(grad, g, plans[1])
    return _half_sq(res, own_ep)


def _scatter_dd(band, grad, p, prob: BatchProblem, threshold, w_dd, robust, plans, z=None):
    """The DD factors, pairs (k, k+1), positions (and with ``z`` the zenith
    bias, the seventh state) only, into (band, grad); returns their rows and
    IRLS weights."""
    D = band.shape[-1]
    R_el = r_ecef_local(prob.anchor_ecef, prob.yaw_enu_local)
    res, JP, w_dd_rows, *Jz = _dd_row_jac(p, R_el, prob, threshold, w_dd, robust, z)
    # ∂p_local/∂p_k = ratio·I, ∂/∂p_k+1 = (1 − ratio)·I; z likewise.
    ratio = prob.ep_ratio[:, None, None]
    Ji = torch.zeros(res.shape + (D,), dtype=F64, device=p.device)
    Ji[..., :3] = JP * ratio
    Jj = torch.zeros_like(Ji)
    Jj[..., :3] = JP * (1.0 - ratio)
    if z is not None:
        Ji[..., POSE_DOF] = Jz[0] * ratio[..., 0]
        Jj[..., POSE_DOF] = Jz[0] * (1.0 - ratio[..., 0])
    _scatter_pair(band, grad, Ji, Jj, res, plans)
    return res, w_dd_rows


# --- solves ------------------------------------------------------------------------

def _damp(band, lam, hw: int):
    """Levenberg damping of the diagonal blocks, in place."""
    D = band.shape[-1]
    eye = torch.eye(D, dtype=F64, device=band.device)
    diag = band[:, hw]
    band[:, hw] = diag + lam * (
        eye * torch.clamp(torch.diagonal(diag, dim1=-2, dim2=-1), min=1.0)[..., None, :] * eye)


def _solve_step(band, grad, solver: str, pcg_iters: int = 200):
    """The step of an LM iteration: exact by cyclic reduction ("direct"), by
    CG preconditioned with the f32 band factor ("chol_pcg"), or by
    ``pcg_iters`` of block-Jacobi PCG ("pcg"; level 0 takes 60 by default,
    the level-1 and zenith-bias solves 200, as the JAX package's)."""
    if solver == "direct":
        return banded.cyclic_reduction_solve(band, -grad)
    if solver == "chol_pcg":
        return banded.pcg_chol_solve(band, -grad)
    return banded.pcg_solve(band, -grad, iters=pcg_iters)[0]


def solve_batch_once(cfg, prob: BatchProblem, p0, q0, threshold,
                     lm_iters: int = 10, pcg_iters: int = 60,
                     solver: str = "direct", robust: RobustOpts = NO_ROBUST,
                     plan: AssemblyPlan = None):
    """One annealing stage: ``lm_iters`` damped Gauss-Newton iterations.

    solver="direct" solves each step exactly by block cyclic reduction;
    "pcg" by ``pcg_iters`` of block-Jacobi PCG; "chol_pcg" by 14 iterations
    of CG preconditioned by the f32 banded Cholesky factor (~1e-5 step
    accuracy, as the JAX package's). ``robust`` re-derives the
    IRLS weights at the current iterate every iteration; the step is
    accepted when the cost under those same frozen weights drops. Nothing
    here waits on the host. On a CUDA device the assembly, the step and the
    trial cost are the replays of CUDA graphs that every stage and every
    problem of the same shapes share (``lm_closures``). Returns (p, q,
    unweighted cost) as tensors.
    """
    _check_supported(cfg, solver)
    hw = cfg.estimator.search_range + 1
    use_doppler = cfg.estimator.doppler_in_batch
    if plan is None:
        plan = assembly_plan(prob, hw, use_doppler)
    # The threshold is data, so one graph serves every annealing stage.
    th = torch.full((), threshold, dtype=F64, device=p0.device)
    assemble, step, trial_cost = lm_closures(
        (prob, plan, th), ("solve_batch_once", hw, solver, pcg_iters, use_doppler, robust),
        lambda d, p, q: _assemble_core_impl(p, q, d[0], d[2], hw, robust=robust, plan=d[1],
                                            use_doppler=use_doppler),
        lambda d, band, grad: _solve_step(band, grad, solver, pcg_iters),
        lambda d, p, q, w_rel, w_dd: _total_cost(p, q, d[0], d[2], w_rel, w_dd, use_doppler))
    p, q = _lm_stage(p0, q0, lm_iters, hw, assemble, step, trial_cost)
    return p, q, _total_cost(p, q, prob, threshold, use_doppler=use_doppler)


# --- the LM closures as CUDA graphs ------------------------------------------------------
#
# An LM iteration of the T = 3493 solve is ~3,100 small kernels whose host
# dispatch takes several times their device time. On a CUDA device each heavy
# closure of the iteration (assembly, step, trial cost) runs instead as the
# replay of a CUDA graph. The graphs outlive the solve, so that every solve of
# a problem of the same shapes (the next drive, the next stage) replays them
# with its own data copied in. One set is kept: it holds a static copy of a
# problem and its graphs' memory, and a problem of another signature replaces
# it.

_GRAPH_SET = None   # the _GraphSet of the latest signature


def _signature(tree):
    """A tree's structure, each tensor as its (shape, dtype), each other
    value as itself: what a graph captured on the tree depends on."""
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype
    if isinstance(tree, tuple):
        return tuple(_signature(x) for x in tree)
    return tree


def _graph_key(data, kind: tuple) -> tuple:
    """The signature ``lm_closures`` keeps a set of graphs for."""
    return (kind, _leaves(data)[0].device) + _signature(data)


def _graph_set(data, kind: tuple):
    """The graph set of ``data``'s signature: the one kept, or a new one in
    its place (the old one freed first)."""
    global _GRAPH_SET
    key = _graph_key(data, kind)
    if _GRAPH_SET is None or _GRAPH_SET.key != key:
        _GRAPH_SET = None
        _GRAPH_SET = _GraphSet(key, data)
    return _GRAPH_SET


class _GraphSet:
    """The CUDA graphs of one signature (``key``): a static copy of the data
    they read (``data``) and, for each closure name and argument signature,
    (graph, static arguments, static outputs)."""

    def __init__(self, key, data):
        self.key = key
        self.data = cloned(data)
        self.live = data          # the data last copied in
        self.graphs = {}

    def call(self, name, fn, data, args):
        """``fn(data, *args)`` as a replay: ``data`` is copied into the static
        copy when it is not the data last copied in, ``args`` at every call;
        the outputs are clones, so no result aliases a static buffer."""
        if data is not self.live:
            for buf, x in zip(_leaves(self.data), _leaves(data)):
                buf.copy_(x)
            self.live = data
        key = (name,) + _signature(args)
        if key not in self.graphs:
            self.graphs[key] = self._capture(fn, args)
            profiling.tally("batch.graph.captures")
        graph, static_args, static_out = self.graphs[key]
        for buf, x in zip(static_args, args):
            buf.copy_(x)
        graph.replay()
        profiling.tally("batch.graph.replays")
        return cloned(static_out)

    def _capture(self, fn, args):
        """(graph, static arguments, static outputs) of ``fn`` on the static
        data and copies of ``args``: one direct run on a side stream first, as
        capture requires, then the capture."""
        static = cloned(args)
        stream = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            fn(self.data, *static)
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(self.data, *static)
        return graph, static, out


def lm_closures(data, kind: tuple, *fns):
    """Each ``fn(data, *args)`` of ``fns`` as a closure of its ``args``.

    ``data`` is a tree of tensors that the closures read and that stays the
    same while they are used (a problem, its plan, a threshold); ``kind``
    names the functions and the Python values they hold (the solver, the
    band half-width). On a CUDA device each closure is the replay of a CUDA
    graph captured at the first call with its signature: ``kind``, the device,
    the structure and tensor shapes and dtypes of ``data`` and of the
    arguments. The functions must read nothing to the host. Off the card
    each is the direct call, tallied ``batch.graph.eager``."""
    dev = _leaves(data)[0].device
    if dev.type != "cuda":
        def direct(fn):
            def call(*args):
                profiling.tally("batch.graph.eager")
                return fn(data, *args)
            return call
        return tuple(direct(fn) for fn in fns)
    graphs = _graph_set(data, kind)

    def graphed(name, fn):
        def call(*args):
            with torch.cuda.device(dev):
                return graphs.call(name, fn, data, args)
        return call
    return tuple(graphed(i, fn) for i, fn in enumerate(fns))


def _lm_stage(p0, q0, lm_iters: int, hw: int, assemble, step, trial_cost, agree=None):
    """``_lm_loop`` over (p, q) (``solve_batch_once``, ``optimize_batch_sharded``).
    Returns (p, q). ``port_bench/reference/batch.py`` wraps it by this name
    and signature to record each iteration's two costs."""
    return _lm_loop((p0, q0), lm_iters, hw, assemble, step, _retract, trial_cost, agree)[0]


def _lm_loop(state, lm_iters: int, hw: int, assemble, step, retract, trial_cost, agree=None,
             cost=None):
    """The LM loop of every batch solve: ``lm_iters`` damped Gauss-Newton
    iterations from ``state``, a tuple of per-keyframe tensors. λ starts at
    1e-4, ×0.3 on an accepted step, ×5 on a rejected one, within [1e-9, 1e6].

    ``assemble(*state)`` → (band, grad, cost, *frozen IRLS weights), ``step(band,
    grad)`` → the step, ``retract(*state, step)`` → the trial, ``trial_cost(*trial,
    *frozen)``, and, where given, ``agree(cost, trial cost)`` → the costs every
    rank compares. Given ``cost`` (level 1), the loop carries it: ``assemble``
    returns (band, grad) and an accepted trial's cost replaces it. Returns
    (state, the carried cost or None)."""
    lam = torch.tensor(1e-4, dtype=F64, device=state[0].device)
    for _ in range(lm_iters):
        with profiling.span("batch.assemble"):
            band, grad, *frozen = assemble(*state)
        current = frozen.pop(0) if cost is None else cost
        _damp(band, lam, hw)
        with profiling.span("batch.linear_solve"):
            dx = step(band, grad)
        trial = retract(*state, dx)
        with profiling.span("batch.trial_cost"):
            trial_c = trial_cost(*trial, *frozen)
        if agree is not None:
            current, trial_c = agree(current, trial_c)
        better = trial_c < current
        state = tuple(torch.where(better, a, b) for a, b in zip(trial, state))
        if cost is not None:
            cost = torch.where(better, trial_c, cost)
        lam = torch.clamp(torch.where(better, lam * 0.3, lam * 5.0), 1e-9, 1e6)
    return state, cost


def _anneal(start, thresholds, lm_iters, stage):
    """The annealing loop of every batch solve: ``stage(state, threshold,
    iters)`` → (*state, cost) per threshold, ``lm_iters`` one count or one a
    stage, the first state from ``start()``, inside the span ``batch.solve``;
    each cost read to the host once. Returns (*state, per-stage costs)."""
    if isinstance(lm_iters, int):
        lm_iters = (lm_iters,) * len(thresholds)
    costs = []
    with profiling.span("batch.solve"):
        state = start()
        for th, iters in zip(thresholds, lm_iters):
            with profiling.span("batch.stage"):
                *state, cost = stage(tuple(state), th, iters)
                with profiling.span("batch.cost_read"):
                    costs.append(float(cost))
    return (*state, costs)


def optimize_batch(cfg, prob: BatchProblem, thresholds=(1e9, 10.0, 8.0, 6.0),
                   lm_iters=10, pcg_iters: int = 60, solver: str = "direct",
                   robust: RobustOpts = NO_ROBUST, init=None, plan: AssemblyPlan = None):
    """The annealed batch solve (Estimator.cpp:2764-2767), one stage per
    threshold. ``lm_iters``: one count, or one per stage. ``init``: an
    optional (p0, q0) warm start in place of the odometry. ``plan``: the
    problem's ``assembly_plan``, when the caller has it (it depends on the
    epochs' binding only). Returns (p, q, per-stage costs); the cost is read
    to the host once per stage.
    """
    _check_supported(cfg, solver)

    def start():
        nonlocal plan
        if plan is None:
            plan = assembly_plan(prob, cfg.estimator.search_range + 1,
                                 cfg.estimator.doppler_in_batch)
        return (prob.p_odo, prob.q_odo) if init is None else init

    return _anneal(start, thresholds, lm_iters,
                   lambda state, th, iters: solve_batch_once(cfg, prob, *state, th, iters,
                                                             pcg_iters, solver, robust, plan))


def optimize_batch_sharded(cfg, prob: BatchProblem, group=None,
                           thresholds=(1e9, 10.0, 8.0, 6.0), lm_iters: int = 10,
                           robust: RobustOpts = NO_ROBUST, device=None):
    """The annealed batch solve over the ranks of a process group (``group``;
    None: the default group; or a ``parallel.Comm``, which then counts the
    solve's collectives), each LM step solved exactly by the SPIKE-
    partitioned cyclic reduction (``parallel.spike_cr``). Every rank of the
    group calls it with the same problem and gets the same result.

    As the JAX package's time-sharded assembly, each rank holds on ``device``
    (None: the problem's) only its slice of the problem, the keyframes it
    owns and a halo, with the epochs that touch them (``parallel.assembly``),
    and assembles only its own band rows, which go straight to the sharded
    solve. The solution comes back whole to every rank, so p and q stay
    whole. Each rank's cost counts only the factors it owns; the current and
    trial costs are summed over the ranks in rank order by one all-gather an
    iteration, so every rank takes the same accept decisions. Each iteration
    is ``solve_batch_once``'s in f64 with the sharded solve in place of
    ``cyclic_reduction_solve``, so the trajectory equals
    ``optimize_batch(solver="direct")``'s to round-off. Any T (the JAX
    function needs T divisible by the devices). Returns (p, q, per-stage
    costs) like ``optimize_batch``.
    """
    from ..parallel import Comm
    from ..parallel.assembly import RankShare
    from ..parallel.spike_cr import make_sharded_cr_solve
    _check_supported(cfg, "direct")
    hw = cfg.estimator.search_range + 1
    T = prob.p_odo.shape[0]
    device = prob.p_odo.device if device is None else torch.device(device)
    comm = Comm.of(group)
    solve = make_sharded_cr_solve(comm, hw)
    share = RankShare(prob, hw, comm.rank, comm.size, cfg.estimator.doppler_in_batch, device)

    def agree(cost, new_cost):
        total = comm.sum_in_rank_order(torch.stack([cost, new_cost]))
        return total[0], total[1]

    def stage(state, th, iters):
        p, q = _lm_stage(*state, iters, hw,
                         lambda p, q: share.assemble(p, q, th, robust),
                         lambda band, grad: solve.rows(band, -grad, T),
                         lambda p, q, w_rel, w_dd: share.cost(p, q, th, w_rel, w_dd),
                         agree)
        return p, q, comm.sum_in_rank_order(share.cost(p, q, th))

    p0, q0 = prob.p_odo.to(device), prob.q_odo.to(device)
    return _anneal(lambda: (p0, q0), thresholds, lm_iters, stage)


# --- covariance ------------------------------------------------------------------

def batch_marginal_covariance(cfg, prob: BatchProblem, p, q, threshold=6.0,
                              jitter: float = 1e-9):
    """Per-keyframe 6×6 marginal covariance (translation, rotation tangent)
    of the batch solution: the block diagonal of the inverse of the
    Gauss-Newton information at (p, q), by banded selected inversion.
    ``jitter`` regularizes the rotation gauge when GNSS constrains only
    translations."""
    _check_supported(cfg)
    hw = cfg.estimator.search_range + 1
    band = _assemble_core_impl(p, q, prob, threshold, hw,
                               use_doppler=cfg.estimator.doppler_in_batch)[0]
    diag = band[:, hw]
    band[:, hw] = diag + (
        jitter * torch.clamp(torch.diagonal(diag, dim1=-2, dim2=-1).sum(-1),
                             min=1.0)[:, None, None]
        * torch.eye(POSE_DOF, dtype=F64, device=p.device))
    return banded.selected_inverse_diag(band)


def calibrate_batch_covariance(cfg, prob: BatchProblem, p, q, cov,
                               threshold=6.0, robust: RobustOpts = None,
                               window: int = 25, kappa_min: float = 0.0,
                               atm_floor_z: float = 0.0):
    """Residual-consistency calibration of the formal batch marginals
    (the JAX package's ``calibrate_batch_covariance``, whose docstring has
    the derivation). Host numpy after one evaluation of the DD rows:

    1. per epoch, the position-domain discrepancy δp_e = −(JᵀJ)⁻¹Jᵀr of
       the whitened, IRLS-weighted DD rows at the converged trajectory;
    2. per keyframe and axis, the windowed median b of δp over the
       ±``window`` nearest epochs, its MAD and its standard error;
    3. the whole-mission median b_glob at full weight, and the windowed
       departure b − b_glob attenuated by how much the window agrees on it
       and by the GNSS-information fraction of the solve;
    4. ``atm_floor_z`` in quadrature on the vertical.

    Returns (calibrated cov (T, 6, 6) as a tensor on p's device, report).
    With fewer than 10 usable epochs the formal marginals are returned.
    """
    if robust is None:
        robust = NO_ROBUST
    T = prob.p_odo.shape[0]
    R_el = r_ecef_local(prob.anchor_ecef, prob.yaw_enu_local)
    res, JP, wf = _dd_row_jac(p, R_el, prob, threshold, None, robust)
    res = res.cpu().numpy()
    JP = JP.cpu().numpy()
    wf = wf.cpu().numpy()
    ep_ok = prob.ep_valid.cpu().numpy()
    ep_left = prob.ep_left.cpu().numpy()
    dps, lefts, infos = [], [], []
    for e in np.where(ep_ok)[0]:
        rows = np.any(JP[e] != 0.0, axis=1)
        if rows.sum() < 4:
            continue
        J = JP[e][rows]
        r = res[e][rows]
        N = J.T @ J
        # Skip geometry-degenerate epochs (few satellites, one system).
        ev = np.linalg.eigvalsh(N)
        if ev[0] < 1e-3 * max(ev[-1], 1e-12):
            continue
        # Gauss-Newton points downhill: the evidence sits at −δp.
        dps.append(-np.linalg.solve(N, J.T @ r))
        lefts.append(ep_left[e])
        infos.append(float(np.mean(wf[e][rows])) * N)
    report = {"n_epochs": len(dps)}
    cov = np.array(torch.as_tensor(cov).cpu().numpy(), float)
    if len(dps) < 10:
        report.update(calibrated=False, median_bias_3d=float("nan"))
        return torch.as_tensor(cov, device=p.device), report
    dp = np.stack(dps)                        # (E', 3) GNSS discrepancies
    info = np.stack(infos)                    # (E', 3, 3) epoch GNSS information
    lefts = np.asarray(lefts)
    b_glob = np.median(dp, axis=0)
    extra = np.zeros((T, 3))
    kappas = np.zeros(T)
    pos_in_seq = np.searchsorted(lefts, np.arange(T))
    for t in range(T):
        c = pos_in_seq[t]
        lo = max(c - window, 0)
        hi = min(c + window, len(dp))
        if hi - lo < 5:
            lo, hi = max(0, len(dp) - 2 * window), len(dp)
            if c < window:
                lo, hi = 0, min(2 * window, len(dp))
        seg = dp[lo:hi]
        b = np.median(seg, axis=0)
        mad = 1.4826 * np.median(np.abs(seg - b), axis=0)
        se = 1.2533 * mad / np.sqrt(seg.shape[0])   # std err of a median
        I_g = info[lo:hi].sum(0)
        r = float(np.trace(cov[t, :3, :3] @ I_g)) / 3.0
        r = min(max(r, 0.0), 0.5)                   # r ≥ 0.5: GNSS dominates
        k_info = min(max(r / (1.0 - r), kappa_min), 1.0)
        b_loc = b - b_glob
        w_cons = b_loc * b_loc / (b_loc * b_loc + mad * mad + 1e-12)
        kappa = w_cons + (1.0 - w_cons) * k_info
        kappas[t] = float(np.mean(kappa))
        extra[t] = (b_glob + kappa * b_loc) ** 2 + se * se
        extra[t, 2] += atm_floor_z ** 2
    cov[:, np.arange(3), np.arange(3)] += extra
    report.update(calibrated=True,
                  median_kappa=float(np.median(kappas)),
                  median_bias_3d=float(np.median(
                      np.linalg.norm(np.sqrt(extra), axis=-1))))
    return torch.as_tensor(cov, device=p.device), report


# --- the Gauss-Markov zenith-bias chain (optimize_batch_atm) ------------------------
#
# A synthesized base station cancels none of the rover's atmosphere, so every
# DD row carries (mf_i − mf_m)·z, z the rover's zenith bias, mf = 1/sin(el).
# z is one more state per keyframe, tied along the chain by a first-order
# Gauss-Markov process and weakly to zero: the system stays banded, with 7×7
# blocks, and every solver applies.

def _gm_chain(z, kf_time, tau, sigma, sigma_abs):
    """Gauss-Markov whitened prior rows on the z chain:
    r_gm[k] = (z_{k+1} − φ_k z_k)/σ_w,k, φ_k = exp(−Δt_k/τ),
    σ_w,k = σ·√(1−φ_k²) (stationary-variance discretization), and the weak
    absolute rows z_k/σ_abs that fix the gauge. Returns (r_gm, r_abs, φ,
    σ_w)."""
    dt = torch.clamp(torch.diff(kf_time), min=1e-3)
    phi = torch.exp(-dt / tau)
    sig_w = sigma * torch.sqrt(torch.clamp(1.0 - phi ** 2, min=1e-8))
    r_gm = (z[1:] - phi * z[:-1]) / sig_w
    return r_gm, z / sigma_abs, phi, sig_w


def _atm_system(cfg, prob: BatchProblem, p, q, z, threshold, hw: int, robust, plan):
    """The 7-dof band and gradient at (p, q, z), with the cost there and the
    IRLS weights: ``_assemble_core_impl``'s rows with their z column, plus
    the Gauss-Markov rows, which couple (k, k+1) at the z index, and the
    absolute rows on z."""
    est = cfg.estimator
    band, grad, cost, w_rel, w_dd = _assemble_core_impl(p, q, prob, threshold, hw,
                                                        robust=robust, plan=plan, z=z)
    r_gm, r_abs, phi, sig_w = _gm_chain(z, prob.kf_time, est.atm_tau, est.atm_sigma,
                                        est.atm_abs_sigma)
    cost = cost + 0.5 * (torch.sum(r_gm ** 2) + torch.sum(r_abs ** 2))
    zi = POSE_DOF
    a_k = -phi / sig_w          # ∂r_gm[k]/∂z_k
    b_k = 1.0 / sig_w           # ∂r_gm[k]/∂z_{k+1}
    band[:-1, hw, zi, zi] += a_k * a_k
    band[:-1, hw + 1, zi, zi] += a_k * b_k
    band[1:, hw - 1, zi, zi] += a_k * b_k
    band[1:, hw, zi, zi] += b_k * b_k
    grad[:-1, zi] += a_k * r_gm
    grad[1:, zi] += b_k * r_gm
    band[:, hw, zi, zi] += 1.0 / est.atm_abs_sigma ** 2
    grad[:, zi] += r_abs / est.atm_abs_sigma
    return band, grad, cost, w_rel, w_dd


def solve_batch_once_atm(cfg, prob: BatchProblem, p0, q0, z0, threshold, lm_iters: int = 10,
                         solver: str = "direct", robust: RobustOpts = NO_ROBUST,
                         plan: AssemblyPlan = None):
    """One annealing stage of the 7-dof (pose + zenith bias) batch: the
    level-0 stage with the z column on the DD rows and the Gauss-Markov
    rows on z, no host sync. Returns (p, q, z, unweighted cost) tensors."""
    _check_solver(solver)
    est = cfg.estimator
    hw = est.search_range + 1
    if plan is None:
        plan = assembly_plan(prob, hw)
    R_el = r_ecef_local(prob.anchor_ecef, prob.yaw_enu_local)

    def trial_cost(p, q, z, w_rel, w_dd):
        r1 = _rel_residuals(p, q, prob, w_rel)
        r2 = _dd_row_jac(p, R_el, prob, threshold, w_dd, z=z)[0]
        r_gm, r_abs, _, _ = _gm_chain(z, prob.kf_time, est.atm_tau, est.atm_sigma,
                                      est.atm_abs_sigma)
        return (0.5 * (torch.sum(r1 * r1) + torch.sum(r2 * r2))
                + 0.5 * (torch.sum(r_gm ** 2) + torch.sum(r_abs ** 2)))

    (p, q, z), _ = _lm_loop(
        (p0, q0, z0), lm_iters, hw,
        lambda p, q, z: _atm_system(cfg, prob, p, q, z, threshold, hw, robust, plan),
        lambda band, grad: _solve_step(band, grad, solver),
        lambda p, q, z, dx: (*_retract(p, q, dx[:, :POSE_DOF]), z + dx[:, POSE_DOF]),
        trial_cost)
    ones_rel = torch.ones(prob.rel_valid.shape, dtype=F64, device=p0.device)
    ones_dd = torch.ones(prob.ep_valid.shape + prob.master.shape[1:] + prob.sv_valid.shape[1:],
                         dtype=F64, device=p0.device)
    return p, q, z, trial_cost(p, q, z, ones_rel, ones_dd)


def optimize_batch_atm(cfg, prob: BatchProblem, thresholds=(1e9, 10.0, 8.0, 6.0),
                       lm_iters=10, solver: str = "direct", robust: RobustOpts = NO_ROBUST):
    """The annealed batch solve with the Gauss-Markov zenith-bias chain, one
    stage per threshold, z starting at zero. Returns (p, q, z, per-stage
    costs); the cost is read to the host once per stage."""
    if cfg.estimator.doppler_in_batch:
        raise ValueError(
            "optimize_batch_atm does not support doppler_in_batch: the "
            "7-dof (pose+zenith) assembly has no Doppler rows — use "
            "optimize_batch, or extend _assemble_core's z-path first "
            "(silently dropping the factors would confound atm A/Bs).")
    _check_solver(solver)
    plan = assembly_plan(prob, cfg.estimator.search_range + 1)
    z0 = torch.zeros(prob.p_odo.shape[0], dtype=F64, device=prob.p_odo.device)
    return _anneal(lambda: (prob.p_odo, prob.q_odo, z0), thresholds, lm_iters,
                   lambda state, th, iters: solve_batch_once_atm(cfg, prob, *state, th, iters,
                                                                 solver, robust, plan))


# --- the reference's re-solve cadence and the incremental mode --------------------

def derive_relatives(p_odo, q_odo, kf_dt, R: int, max_speed: float = 30.0):
    """Relative-pose measurements (T, R, 3), (T, R, 4) and their validity
    (T, R) to the forward neighbours 1..R of a trajectory (tensors). The
    reference re-derives them from the continuously corrected trajectory at
    every batch run, which lets later runs heal earlier odometry jumps.
    Relatives implying more than ``max_speed`` m/s are invalid."""
    T = p_odo.shape[0]
    dev = p_odo.device
    idx = torch.arange(T, device=dev)
    unit = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=F64, device=dev)
    dps, dqs, oks = [], [], []
    for r in range(1, R + 1):
        qj = torch.roll(q_odo, -r, dims=0)
        pj = torch.roll(p_odo, -r, dims=0)
        dq = quat.mul(quat.conj(q_odo), qj)
        dp = quat.rotate(quat.conj(q_odo), pj - p_odo)
        ok = idx < T - r
        speed = torch.linalg.norm(dp, dim=-1) / (r * kf_dt)
        dps.append(torch.where(ok[:, None], dp, torch.zeros_like(dp)))
        dqs.append(torch.where(ok[:, None], dq, unit))
        oks.append(ok & (speed < max_speed))
    return torch.stack(dps, 1), torch.stack(dqs, 1), torch.stack(oks, 1)


def _mask_prefix(rel_valid, ep_valid, ep_left, n: int):
    """The masks of the active prefix [0, n): relatives whose both ends lie
    in it, epochs bound to a keyframe pair inside it. One problem shape for
    every prefix."""
    T, R = rel_valid.shape
    idx = torch.arange(T, device=rel_valid.device)
    offs = torch.arange(1, R + 1, device=rel_valid.device)
    rel_valid = rel_valid & (idx < n)[:, None] & (idx[:, None] + offs[None, :] < n)
    return rel_valid, ep_valid & (ep_left + 1 < n)


def _original_hops(prob: BatchProblem):
    """The consecutive-keyframe odometry hops (Δp in the older frame, Δq) of
    the problem's trajectory, numpy, once."""
    q = prob.q_odo
    hop_dq = quat.mul(quat.conj(q[:-1]), q[1:]).cpu().numpy()
    hop_dp = quat.rotate(quat.conj(q[:-1]), prob.p_odo[1:] - prob.p_odo[:-1]).cpu().numpy()
    return hop_dp, hop_dq


def _chain_hops(p_cur, q_cur, hop_dp, hop_dq, lo, hi):
    """Chain the original odometry hops from pose lo − 1 through [lo, hi),
    in place in the numpy arrays ``p_cur`` / ``q_cur`` (returned too):
    host numpy one pose at a time, as in the JAX package."""
    for k in range(max(lo, 1), hi):
        qp = q_cur[k - 1]
        qk = quat.mul_np(qp, hop_dq[k - 1])
        p_cur[k] = p_cur[k - 1] + quat.rotate_np(qp, hop_dp[k - 1])
        q_cur[k] = qk / np.linalg.norm(qk)
    return p_cur, q_cur


def _synced_clock(device):
    """Seconds on the host clock, after the device's queued work is done."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def optimize_batch_reference_cadence(cfg, prob: BatchProblem, every: int = 10,
                                     lm_iters=4, thresholds=(1e9, 10.0, 8.0, 6.0),
                                     final_lm_iters=(40, 12, 8, 8), solver: str = "direct",
                                     robust: RobustOpts = NO_ROBUST, warm_start: bool = False,
                                     warm_thresholds=(6.0,), warm_lm_iters=4,
                                     verbose: bool = False):
    """The reference's backendFusionThread cadence (Estimator.cpp:2740-2751):
    once 30 keyframes exist, every ``every`` new ones, a fresh annealed
    batch solve of the prefix from the window's own snapshot, sharing no
    state with the run before; then the full-trajectory solve at
    ``final_lm_iters``. ``warm_start`` (beyond the reference) starts each
    re-solve from the previous solution with the new tail chained in by the
    original odometry hops, at ``warm_thresholds`` × ``warm_lm_iters``: the
    constraints are unchanged, and the final solve stays the cold one.

    Returns (p, q, stats) with the per-re-solve wall-clock seconds (the
    device synchronized before each reading): ``n_resolves``, ``final_s``,
    ``resolve_mean_s``, ``resolve_p50_s``, ``resolve_max_s``, ``total_s``.
    """
    _check_supported(cfg, solver)
    dev = prob.p_odo.device
    T = prob.p_odo.shape[0]
    plan = assembly_plan(prob, cfg.estimator.search_range + 1, cfg.estimator.doppler_in_batch)
    if warm_start:
        hop_dp, hop_dq = _original_hops(prob)
    p_cur = q_cur = None
    n_prev = 0
    times = []
    for n in range(30, T, every):
        rel_valid, ep_valid = _mask_prefix(prob.rel_valid, prob.ep_valid, prob.ep_left, n)
        prob_n = prob._replace(rel_valid=rel_valid, ep_valid=ep_valid)
        t0 = _synced_clock(dev)
        if warm_start and p_cur is not None:
            # The hop chaining is host work inside the timed region: it is
            # part of what replaces the fresh solve.
            _chain_hops(p_cur, q_cur, hop_dp, hop_dq, n_prev, n)
            init = (torch.as_tensor(p_cur, device=dev), torch.as_tensor(q_cur, device=dev))
            p, q, costs = optimize_batch(cfg, prob_n, thresholds=warm_thresholds,
                                         lm_iters=warm_lm_iters, solver=solver, robust=robust,
                                         init=init, plan=plan)
        else:
            p, q, costs = optimize_batch(cfg, prob_n, thresholds=thresholds, lm_iters=lm_iters,
                                         solver=solver, robust=robust, plan=plan)
        times.append(_synced_clock(dev) - t0)
        if warm_start:
            if p_cur is None:
                p_cur, q_cur = p.cpu().numpy().copy(), q.cpu().numpy().copy()
            else:
                p_cur[:n] = p[:n].cpu().numpy()
                q_cur[:n] = q[:n].cpu().numpy()
            n_prev = n
        if verbose and (n // every) % 20 == 0:
            print(f"  batch re-solve n={n}: {times[-1]:.2f} s cost {costs[-1]:.0f}", flush=True)
    t0 = _synced_clock(dev)
    p, q, _ = optimize_batch(cfg, prob, thresholds=thresholds, lm_iters=final_lm_iters,
                             solver=solver, robust=robust, plan=plan)
    t_final = _synced_clock(dev) - t0
    times_arr = np.asarray(times) if times else np.zeros(1)
    stats = {"n_resolves": len(times), "final_s": t_final,
             "resolve_mean_s": float(times_arr.mean()),
             "resolve_p50_s": float(np.median(times_arr)),
             "resolve_max_s": float(times_arr.max()),
             "total_s": float(times_arr.sum() + t_final)}
    return p, q, stats


def optimize_batch_incremental(cfg, prob: BatchProblem, kf_time, every: int = 50,
                               thresholds=(1e9, 10.0, 8.0, 6.0), lm_iters=4,
                               solver: str = "direct", relaxation_passes: int = 0,
                               robust: RobustOpts = NO_ROBUST, rederive: bool = True,
                               verbose: bool = False, timings: dict = None):
    """The reference's incremental batch replay (backendFusionThread,
    Estimator.cpp:5352, 2740-2748): re-solve the growing prefix every
    ``every`` keyframes, one problem shape with masks for every prefix. Each
    incoming chunk is chained onto the corrected boundary by the original
    odometry hops (host numpy); ``rederive`` (the reference's way) derives
    the relatives anew from the corrected trajectory at each re-solve.
    ``relaxation_passes`` then re-derive and re-solve the whole trajectory
    (2 LM iterations at the last threshold each). ``prob`` supplies the
    GNSS binding and whitening and the starting odometry. With ``timings``
    (a dict), each prefix re-solve's wall-clock seconds, the device
    synchronized before each reading, go to ``timings["resolve_s"]``.
    Returns (p, q).
    """
    _check_supported(cfg, solver)
    dev = prob.p_odo.device
    T = prob.p_odo.shape[0]
    R = prob.rel_valid.shape[1]
    kf_dt = float(np.median(np.diff(np.asarray(kf_time))))
    plan = assembly_plan(prob, cfg.estimator.search_range + 1, cfg.estimator.doppler_in_batch)
    hop_dp, hop_dq = _original_hops(prob)
    p_cur = prob.p_odo.cpu().numpy().copy()
    q_cur = prob.q_odo.cpu().numpy().copy()
    n_prev = 0
    times = timings.setdefault("resolve_s", []) if timings is not None else []
    for n in list(range(max(every, 20), T, every)) + [T]:
        t0 = _synced_clock(dev)
        _chain_hops(p_cur, q_cur, hop_dp, hop_dq, n_prev, n)
        n_prev = n
        p_t = torch.as_tensor(p_cur, device=dev)
        q_t = torch.as_tensor(q_cur, device=dev)
        rel_dp, rel_dq, rel_valid = (derive_relatives(p_t, q_t, kf_dt, R) if rederive
                                     else (prob.rel_dp, prob.rel_dq, prob.rel_valid))
        rel_valid, ep_valid = _mask_prefix(rel_valid, prob.ep_valid, prob.ep_left, n)
        prob_n = prob._replace(p_odo=p_t, q_odo=q_t, rel_dp=rel_dp, rel_dq=rel_dq,
                               rel_valid=rel_valid, ep_valid=ep_valid)
        p_new, q_new, costs = optimize_batch(cfg, prob_n, thresholds=thresholds,
                                             lm_iters=lm_iters, solver=solver, robust=robust,
                                             plan=plan)
        # Poses beyond the prefix keep their values until chained in.
        p_cur[:n] = p_new[:n].cpu().numpy()
        q_cur[:n] = q_new[:n].cpu().numpy()
        times.append(_synced_clock(dev) - t0)
        if verbose:
            print(f"  incremental batch n={n}: cost {costs[-1]:.0f}", flush=True)
    # Each pass re-derives the relatives from the current estimate, one more
    # equilibrium step toward the GNSS evidence (the reference gets ~T/10 of
    # them by re-running every 10 keyframes).
    for it in range(relaxation_passes):
        p_t = torch.as_tensor(p_cur, device=dev)
        q_t = torch.as_tensor(q_cur, device=dev)
        rel_dp, rel_dq, rel_valid = derive_relatives(p_t, q_t, kf_dt, R)
        prob_n = prob._replace(p_odo=p_t, q_odo=q_t, rel_dp=rel_dp, rel_dq=rel_dq,
                               rel_valid=rel_valid)
        p_new, q_new, cost = solve_batch_once(cfg, prob_n, p_t, q_t, thresholds[-1], 2, 60,
                                              solver, robust, plan)
        p_cur = p_new.cpu().numpy()
        q_cur = q_new.cpu().numpy()
        if verbose and (it % 10 == 9):
            print(f"  relaxation {it + 1}: cost {float(cost):.0f}", flush=True)
    return torch.as_tensor(p_cur, device=dev), torch.as_tensor(q_cur, device=dev)


# --- level 1: binary scan-to-multiscan planes and IMU chains ----------------------
#
# sms_fusion_level=1 (Estimator.cpp:2990-3077): the level-0 relative-pose rows
# give way to binary point-to-plane factors between each keyframe i and
# i + 1..R (BinaryLidarPlaneNormFactor, LidarKeyframeFactor.h:124-164); the
# relative-attitude rows and the DD rows stay, and ImuFactor chains join over
# 15-dof keyframe states (p, θ, v, ba, bg).

SMS1_CHUNK = 2048   # keyframe pairs associated at a time: ~1.5 GB of intermediates
STATE15 = 15        # δp, δθ, δv, δba, δbg per keyframe


class Sms1Data(NamedTuple):
    """Correspondences of level 1: F points of frame i against planes
    (normal, centroid) in frame j = i + r + 1's body frame, per (i, r)
    (reference association ``findGlobalCorrespondingSurfFeatures_Batch``,
    Estimator.cpp:3710-3806; the 25 of 400 kept here are the top 25 by
    planarity, deterministically)."""
    pts_i: torch.Tensor       # (T, R, F, 3) points of frame i
    normal_j: torch.Tensor    # (T, R, F, 3) plane normals, frame j
    cent_j: torch.Tensor      # (T, R, F, 3) plane centroids, frame j
    score: torch.Tensor       # (T, R, F)
    mask: torch.Tensor        # (T, R, F) bool


def _lap(timings, key, t0, device):
    """When ``timings`` is a dict: sync the device and add the seconds since
    ``t0`` to ``timings[key]`` (none for key None); returns the time now."""
    if timings is None:
        return t0
    t = _synced_clock(device)
    if key is not None:
        timings[key] = timings.get(key, 0.0) + t - t0
    return t


def sms1_pairs(T: int, R: int, device):
    """Every keyframe pair of level 1, offset-major as in the JAX package:
    (i_idx, j_idx = i + r + 1, r_idx) int64 tensors on ``device``."""
    i_idx, r_idx = [], []
    for r in range(R):
        n = max(T - r - 1, 0)
        i_idx.append(np.arange(n))
        r_idx.append(np.full(n, r))
    i = np.concatenate(i_idx)
    r = np.concatenate(r_idx)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
    return as_t(i), as_t(i + r + 1), as_t(r)


def world_points(scans, p, q):
    """(T, S, 3) f32: every keyframe's scan taken to the world by its pose,
    in f64 and rounded once. The JAX package transforms both scans of each
    pair the same way; doing it once a frame gives the same bits. Like the
    JAX package (and unlike the window), level 1 applies the pose to the
    lidar-frame points directly, without the lidar-body extrinsic."""
    return (quat.rotate(q[:, None, :], scans.to(F64)) + p[:, None, :]).to(torch.float32)


def build_sms1(cfg, scans, scans_valid, p_odo, q_odo, chunk: int = SMS1_CHUNK, *,
               device, timings: dict = None) -> Sms1Data:
    """Associate every (i, i + r + 1) keyframe pair's scans at the poses
    (p_odo, q_odo), ``chunk`` pairs at a time, on ``device``: the 5-NN of
    frame i's points in frame j's (``ops.knn.knn_pairs``), plane fits of
    the neighbourhoods (planarity ≥ 0.8), the top F by planarity of the
    points whose nearest neighbour is within ``kd_max_radius``, and the
    planes taken to frame j's body frame. The result does not depend on
    ``chunk``. With ``timings`` (a dict), each step is closed by a device
    sync and its seconds are added under "knn", "planes" and "select".
    """
    from ..lidar import neighbors, plane_fit
    from ..ops.knn import knn_pairs
    est = cfg.estimator
    T, S = scans_valid.shape[:2]
    R = est.search_range
    F = cfg.feature_selection.batch_feature_res_num
    dev = torch.device(device)
    scans = torch.as_tensor(np.asarray(scans), device=dev).to(torch.float32)
    scans_valid = torch.as_tensor(np.asarray(scans_valid), device=dev).to(torch.bool)
    p = torch.as_tensor(np.asarray(p_odo, float), dtype=F64, device=dev)
    q = torch.as_tensor(np.asarray(q_odo, float), dtype=F64, device=dev)
    world = world_points(scans, p, q)
    r_max2 = est.kd_max_radius ** 2

    out = Sms1Data(*(torch.zeros((T, R, F, 3), dtype=F64, device=dev) for _ in range(3)),
                   torch.zeros((T, R, F), dtype=F64, device=dev),
                   torch.zeros((T, R, F), dtype=torch.bool, device=dev))
    i_all, j_all, r_all = sms1_pairs(T, R, dev)
    for c0 in range(0, i_all.shape[0], chunk):
        ii, jj, rr = i_all[c0:c0 + chunk], j_all[c0:c0 + chunk], r_all[c0:c0 + chunk]
        t0 = _lap(timings, None, 0.0, dev)
        d2, idx = knn_pairs(world, scans_valid, ii, jj)
        t0 = _lap(timings, "knn", t0, dev)
        neigh = neighbors.gather_neighbors(world[jj], idx)
        nrm, cent, planarity, ok = plane_fit.fit_planes_centroid(neigh, idx >= 0,
                                                                 min_planarity=0.8)
        t0 = _lap(timings, "planes", t0, dev)
        good = ok & scans_valid[ii] & (d2[..., 0] < r_max2)
        sc = torch.where(good, planarity, torch.full_like(planarity, -1.0))
        # jax.lax.top_k: the largest first, ties to the lowest index.
        top_s, top_i = torch.sort(sc, dim=-1, descending=True, stable=True)
        top_s, top_i = top_s[:, :F], top_i[:, :F]
        take = lambda a: torch.gather(a, 1, top_i[..., None].expand(-1, -1, 3)).to(F64)
        qj_inv = quat.conj(q[jj])[:, None, :]
        out.pts_i[ii, rr] = take(scans[ii])
        out.normal_j[ii, rr] = quat.rotate(qj_inv, take(nrm))
        out.cent_j[ii, rr] = quat.rotate(qj_inv, take(cent) - p[jj][:, None, :])
        out.score[ii, rr] = (est.lidar_const * top_s).to(F64)
        out.mask[ii, rr] = top_s > 0
        _lap(timings, "select", t0, dev)
    return out


def _att_residuals(p, q, prob: BatchProblem):
    """(T, R, 3) relative-attitude rows: the first three of ``_rel_residuals``."""
    rows = []
    for r in range(prob.rel_valid.shape[1]):
        qj = torch.roll(q, -(r + 1), dims=0)
        err_q = quat.mul(quat.conj(prob.rel_dq[:, r]), quat.mul(quat.conj(q), qj))[:, 1:]
        row = W_ATT * err_q
        rows.append(torch.where(prob.rel_valid[:, r][:, None], row, torch.zeros_like(row)))
    return torch.stack(rows, dim=1)


def _sms1_residuals(p, q, sms: Sms1Data):
    """(T, R, F) binary point-to-plane residuals."""
    from ..factors.lidar import binary_plane_residual
    rows = []
    for r in range(sms.pts_i.shape[1]):
        pj = torch.roll(p, -(r + 1), dims=0)
        qj = torch.roll(q, -(r + 1), dims=0)
        rows.append(binary_plane_residual(sms.pts_i[:, r], sms.normal_j[:, r],
                                          sms.cent_j[:, r], sms.score[:, r], p, q, pj, qj,
                                          sms.mask[:, r]))
    return torch.stack(rows, dim=1)


def _sms1_cost(p, q, prob, sms, threshold):
    r_att = _att_residuals(p, q, prob)
    r_sms = _sms1_residuals(p, q, sms)
    r_dd = _dd_residuals(p, prob, threshold)
    return 0.5 * (torch.sum(r_att * r_att) + torch.sum(r_sms * r_sms)
                  + torch.sum(r_dd * r_dd))


def _assemble_sms1_pose(p, q, prob: BatchProblem, sms: Sms1Data, threshold, hw: int,
                        plan: AssemblyPlan = None):
    """6-dof band and gradient of the attitude, binary-plane and DD rows.

    Analytic Jacobians: for r = s·n_wᵀ(p_w − c_w) under the right
    retraction q ⊞ δ = q·exp(δ),
      ∂r/∂t1 =  s·n_w          ∂r/∂δθ1 = s·(p_b × R1ᵀn_w)
      ∂r/∂t2 = −s·n_w          ∂r/∂δθ2 = s·(n_b × R2ᵀ(p_w − c_w) − c_b × n_b);
    the attitude rows as in level 0. The DD rows are assembled into a band
    of their own and added, as the JAX package does. Shared by the
    pose-only and the 15-dof solves. Returns (band (T, 2hw+1, 6, 6),
    grad (T, 6)).
    """
    T = p.shape[0]
    D = POSE_DOF
    dev = p.device
    if plan is None:
        plan = assembly_plan(prob, hw)
    band = torch.zeros((T, 2 * hw + 1, D, D), dtype=F64, device=dev)
    grad = torch.zeros((T, D), dtype=F64, device=dev)
    for r, plans in enumerate(plan.rel):
        pj = torch.roll(p, -(r + 1), dims=0)
        qj = torch.roll(q, -(r + 1), dims=0)
        m_att = prob.rel_valid[:, r].to(F64)
        # Attitude rows: W_ATT·vec(Δq̄⁻¹ qi⁻¹ qj).
        Mq = quat.conj(prob.rel_dq[:, r])
        Q = quat.mul(quat.conj(q), qj)
        MQ = quat.mul(Mq, Q)
        res_att = W_ATT * MQ[:, 1:] * m_att[:, None]
        JqjR = 0.5 * quat.qleft(MQ)[:, 1:, 1:]
        JqiR = -0.5 * (quat.qleft(Mq) @ quat.qright(Q))[:, 1:, 1:]
        Ji_att = torch.zeros((T, 3, D), dtype=F64, device=dev)
        Ji_att[:, :, 3:6] = W_ATT * JqiR
        Jj_att = torch.zeros((T, 3, D), dtype=F64, device=dev)
        Jj_att[:, :, 3:6] = W_ATT * JqjR
        Ji_att = Ji_att * m_att[:, None, None]
        Jj_att = Jj_att * m_att[:, None, None]

        # Binary plane rows, batched over (T, F).
        pts, nrm, cen = sms.pts_i[:, r], sms.normal_j[:, r], sms.cent_j[:, r]
        scm = sms.score[:, r] * sms.mask[:, r].to(F64)
        p_w = quat.rotate(q[:, None, :], pts) + p[:, None, :]
        n_w = quat.rotate(qj[:, None, :], nrm)
        c_w = quat.rotate(qj[:, None, :], cen) + pj[:, None, :]
        res_pl = scm * torch.sum(n_w * (p_w - c_w), dim=-1)
        R1t_nw = quat.rotate(quat.conj(q)[:, None, :], n_w)
        R2t_d = quat.rotate(quat.conj(qj)[:, None, :], p_w - c_w)
        s3 = scm[..., None]
        Ji_pl = torch.cat([s3 * n_w, s3 * quat.cross(pts, R1t_nw)], dim=-1)
        Jj_pl = torch.cat([-s3 * n_w, s3 * (quat.cross(nrm, R2t_d) - quat.cross(cen, nrm))],
                          dim=-1)
        _scatter_pair(band, grad, torch.cat([Ji_att, Ji_pl], dim=1),
                      torch.cat([Jj_att, Jj_pl], dim=1), torch.cat([res_att, res_pl], dim=1),
                      plans)

    band_dd = torch.zeros_like(band)
    grad_dd = torch.zeros_like(grad)
    w_dd = torch.ones(prob.ep_valid.shape + prob.master.shape[1:] + prob.sv_valid.shape[1:],
                      dtype=F64, device=dev)
    _scatter_dd(band_dd, grad_dd, p, prob, threshold, w_dd, None, plan.dd)
    return band + band_dd, grad + grad_dd


def _sms1_solve_once(cfg, prob: BatchProblem, sms: Sms1Data, p0, q0, threshold,
                     lm_iters: int, plan: AssemblyPlan, solver: str = "direct"):
    """One annealing stage of the pose-only level-1 solve, ``lm_iters`` of
    ``_lm_loop``, each step by ``_solve_step``. Returns (p, q, cost)."""
    hw = cfg.estimator.search_range + 1
    (p, q), cost = _lm_loop(
        (p0, q0), lm_iters, hw,
        lambda p, q: _assemble_sms1_pose(p, q, prob, sms, threshold, hw, plan),
        lambda band, grad: _solve_step(band, grad, solver), _retract,
        lambda p, q: _sms1_cost(p, q, prob, sms, threshold),
        cost=_sms1_cost(p0, q0, prob, sms, threshold))
    return p, q, cost


def optimize_batch_sms1(cfg, prob: BatchProblem, sms: Sms1Data,
                        thresholds=(1e9, 10.0, 8.0, 6.0), lm_iters: int = 6,
                        solver: str = "direct"):
    """Level 1 without the IMU chains (pose-only): attitude, binary-plane
    and DD rows, one annealing stage per threshold, each step by
    ``solver`` ("direct", "chol_pcg" or "pcg"). Returns (p, q, per-stage
    costs)."""
    _check_solver(solver)
    plan = assembly_plan(prob, cfg.estimator.search_range + 1)
    return _anneal(lambda: (prob.p_odo, prob.q_odo), thresholds, lm_iters,
                   lambda state, th, iters: _sms1_solve_once(cfg, prob, sms, *state, th, iters,
                                                             plan, solver))


class ImuChainData(NamedTuple):
    """Preintegrated IMU edges k → k + 1 for level 1's chains (ImuFactor
    rows, Estimator.cpp:2992-3001; edge k uses the interval that ends at
    keyframe k + 1)."""
    pres: object                # imu.Preintegrated, leading dim (T-1,)
    sqrt_info: torch.Tensor     # (T-1, 15, 15)
    valid: torch.Tensor         # (T-1,) bool


def _imu_params(cfg):
    from ..factors import imu as imu_factors
    c = cfg.imu
    return imu_factors.ImuParams(c.acc_n, c.gyr_n, c.acc_w, c.gyr_w, c.gravity)


def build_imu_chain(cfg, imu_acc, imu_gyr, imu_dt, imu_valid, *, device) -> ImuChainData:
    """Preintegrate every keyframe interval at zero bias, as the reference's
    batch reuses the window's ``pre_integrations`` (the factor's
    first-order bias correction absorbs the batch's bias updates).

    Args are the episode's per-interval buffers (T, NI, ...); interval 0,
    before the first keyframe, is skipped, and each interval's midpoint
    pair is seeded with its own first sample (the reference seeds with the
    sample at the keyframe: at 100 Hz, one sub-sample of lever). The JAX
    package's optional seeds and bias points, which no caller passes, are
    not ported.
    """
    from ..factors import imu as imu_factors
    dev = torch.device(device)
    f = lambda a: torch.as_tensor(np.asarray(a, float), dtype=F64, device=dev)
    acc, gyr, dt = f(imu_acc)[1:], f(imu_gyr)[1:], f(imu_dt)[1:]
    val = torch.as_tensor(np.asarray(imu_valid), device=dev).to(torch.bool)[1:]
    zero = torch.zeros((acc.shape[0], 3), dtype=F64, device=dev)
    pres = imu_factors.preintegrate(acc, gyr, dt, val, zero, zero, acc[:, 0], gyr[:, 0],
                                    _imu_params(cfg).noise_cov(dev))
    return ImuChainData(pres=pres, sqrt_info=imu_factors.sqrt_info(pres),
                        valid=torch.any(val, dim=1))


def _retract15(p, q, v, ba, bg, dx):
    d = dx.reshape(p.shape[0], STATE15)
    return (p + d[:, 0:3], quat.normalize(quat.mul(q, quat.exp(d[:, 3:6]))),
            v + d[:, 6:9], ba + d[:, 9:12], bg + d[:, 12:15])


def _imu_chain_residuals_at(xi, xj, chain: ImuChainData, gravity):
    """(T-1, 15) whitened IMU edge residuals between the states xi and xj,
    each (p, q, v, ba, bg); zero on edges without samples."""
    from ..factors import imu as imu_factors
    r = imu_factors.whitened_residual_cached(chain.sqrt_info, chain.pres, *xi, *xj,
                                             gravity=gravity)
    return torch.where(chain.valid[:, None], r, torch.zeros_like(r))


def _imu_chain_jacobians(p, q, v, ba, bg, chain: ImuChainData, gravity):
    """Every edge's whitened residual (T-1, 15) and its Jacobians (T-1, 15,
    15) with respect to the tangents of keyframes k and k + 1.

    One forward-mode pass over a single 30-vector tangent added to every
    edge's (k, k + 1) states: edge k's residual depends only on its own
    copy, so the (T-1, 15, 30) result holds each edge's Jacobian. The
    perturbation is the JAX package's (q·exp(δθ), not renormalized).
    """
    x = (p, q, v, ba, bg)

    def perturb(s, d):
        return (s[0] + d[0:3], quat.mul(s[1], quat.exp(d[3:6])), s[2] + d[6:9],
                s[3] + d[9:12], s[4] + d[12:15])

    def edges(delta):
        r = _imu_chain_residuals_at(perturb(tuple(a[:-1] for a in x), delta[:STATE15]),
                                    perturb(tuple(a[1:] for a in x), delta[STATE15:]),
                                    chain, gravity)
        return r, r

    zero = torch.zeros(2 * STATE15, dtype=F64, device=p.device)
    J, res = torch.func.jacfwd(edges, has_aux=True)(zero)
    return res, J[..., :STATE15], J[..., STATE15:]


def _sms1_imu_cost(p, q, v, ba, bg, prob, sms, chain, threshold, gravity):
    x = (p, q, v, ba, bg)
    r_imu = _imu_chain_residuals_at(tuple(a[:-1] for a in x), tuple(a[1:] for a in x),
                                    chain, gravity)
    return _sms1_cost(p, q, prob, sms, threshold) + 0.5 * torch.sum(r_imu * r_imu)


def _sms1_imu_system(p, q, v, ba, bg, prob, sms, chain, threshold, hw, plan, imu_plan,
                     gravity):
    """The 15-dof band (T, 2hw+1, 15, 15) and gradient (T, 15): the pose
    rows in the [0:6, 0:6] corner of each block, the IMU edges over the
    full blocks of the first off-diagonal."""
    T = p.shape[0]
    band6, grad6 = _assemble_sms1_pose(p, q, prob, sms, threshold, hw, plan)
    band = torch.zeros((T, 2 * hw + 1, STATE15, STATE15), dtype=F64, device=p.device)
    band[:, :, :POSE_DOF, :POSE_DOF] = band6
    grad = torch.zeros((T, STATE15), dtype=F64, device=p.device)
    grad[:, :POSE_DOF] = grad6
    res, Ji, Jj = _imu_chain_jacobians(p, q, v, ba, bg, chain, gravity)
    _scatter_pair(band, grad, Ji, Jj, res, imu_plan)
    return band, grad


def imu_chain_plan(T: int, hw: int, device) -> tuple:
    """Scatter plans of the IMU edges (k, k + 1)."""
    k = np.arange(T - 1)
    return pair_plans(k, k + 1, hw, device)


def _sms1_imu_solve_once(cfg, prob, sms, chain, state, threshold, lm_iters: int,
                         plan, imu_plan, solver: str = "direct"):
    """One annealing stage of the 15-dof level-1 solve from ``state`` = (p, q,
    v, ba, bg), each step by ``_solve_step``. Returns (p, q, v, ba, bg, cost)."""
    hw = cfg.estimator.search_range + 1
    gravity = _imu_params(cfg).gravity_vec(prob.p_odo.device)
    state, cost = _lm_loop(
        state, lm_iters, hw,
        lambda *s: _sms1_imu_system(*s, prob, sms, chain, threshold, hw, plan, imu_plan,
                                    gravity),
        lambda band, grad: _solve_step(band, grad, solver), _retract15,
        lambda *s: _sms1_imu_cost(*s, prob, sms, chain, threshold, gravity),
        cost=_sms1_imu_cost(*state, prob, sms, chain, threshold, gravity))
    return (*state, cost)


def initial_velocity(prob: BatchProblem):
    """Central differences of the odometry over the median keyframe spacing
    (the reference carries the window's speed states into the batch)."""
    return torch.gradient(prob.p_odo, dim=0)[0] / torch.clamp(prob.kf_dt, min=1e-3)


def optimize_batch_sms1_imu(cfg, prob: BatchProblem, sms: Sms1Data, chain: ImuChainData,
                            v0=None, thresholds=(1e9, 10.0, 8.0, 6.0), lm_iters: int = 6,
                            solver: str = "direct"):
    """The reference's level 1 (Estimator.cpp:2990-3077): IMU chains,
    binary planes, relative attitude and DD pseudoranges over 15-dof
    keyframe states, one block-banded system with 15×15 blocks, one
    annealing stage per threshold, each step by ``solver`` ("direct",
    "chol_pcg": the f32 band factor at D = 15, or "pcg"). The velocities
    start at ``v0`` (T, 3), or at differences of the odometry; the biases at
    zero. Returns (p, q, v, ba, bg, per-stage costs); the cost is read to
    the host once per stage."""
    _check_solver(solver)
    T = prob.p_odo.shape[0]
    dev = prob.p_odo.device
    hw = cfg.estimator.search_range + 1
    plan = assembly_plan(prob, hw)
    imu_plan = imu_chain_plan(T, hw, dev)
    v = (initial_velocity(prob) if v0 is None
         else torch.as_tensor(np.asarray(v0, float), dtype=F64, device=dev))
    zeros = torch.zeros((T, 3), dtype=F64, device=dev)
    return _anneal(lambda: (prob.p_odo, prob.q_odo, v, zeros, zeros), thresholds, lm_iters,
                   lambda s, th, iters: _sms1_imu_solve_once(cfg, prob, sms, chain, s, th,
                                                             iters, plan, imu_plan, solver))
