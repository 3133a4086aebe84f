"""RTK positioning: per-epoch DD fixes and the carrier-phase float filter
(port of ``glio_tpu/gnss/rtk.py``).

The code-only DD Gauss-Newton fix that stage 3 gates on covariance
(Estimator.cpp:1963-1969) and that backend fusion's divergence gate uses as
an independent absolute position. ``solve_epochs_dd`` solves every epoch
at once over a leading epoch axis; ``solve_epoch_dd`` is the one-epoch
case. Weights are the inverse goGPS variance of the non-master satellite;
``huber`` (sigma multiples, from iteration 2) and ``trim`` (metres, from
iteration 4) reweight per satellite. The iteration count is fixed and
nothing waits on the host.

``float_filter`` is the reference's ``rtkpos`` float solution: a forward
Kalman filter over (position, velocity, single-difference float
ambiguities) fusing DD carrier phase, DD pseudorange and Doppler, with
innovation-gated robust weights and a reported covariance inflated by the
filter's own consistency (the JAX package's docstring has the why of each
term). The JAX package runs it as one ``lax.scan``; here it is a Python loop
over the epochs on the device, with everything that does not depend on the
filter's state computed for all epochs at once before it, no host sync
inside it, and the outputs stacked once at the end. ``arc_tracking`` (the
cycle-slip segmentation) is host numpy, as in JAX. The integer ambiguity
resolution over the filter's output is ``lambda_ar`` (host numpy, a copy).
"""

from typing import NamedTuple

import numpy as np
import torch

from ..solver.linalg import spd_solve
from .dd import elesnr_var


def _pair_structure(valid, system, master):
    """(pair_mask, master_of) of the DD pairs over leading epoch axes:
    valid / system (..., M), master (..., n_sys)."""
    M = valid.shape[-1]
    slot = torch.arange(M, device=valid.device)
    system = system.long()
    master = master.long()
    pair_mask = torch.zeros_like(valid)
    master_of = torch.zeros(valid.shape, dtype=torch.int64, device=valid.device)
    for s in range(master.shape[-1]):
        mp = master[..., s:s + 1]
        mp_safe = torch.clamp(mp, min=0)
        m = valid & (system == s) & (slot != mp_safe) & (mp >= 0)
        pair_mask = pair_mask | m
        master_of = torch.where(m, mp_safe, master_of)
    return pair_mask, master_of


def solve_epochs_dd(sat_pos, psr_rov, psr_sta, valid, system, master, station_ecef,
                    el, snr, x0, iters: int = 8, huber: float | None = None,
                    trim: float | None = None):
    """DD fixes of E epochs: sat_pos (E, M, 3), psr_rov / psr_sta / valid /
    system / el / snr (E, M), master (E, n_sys), station_ecef (3,), x0 (3,)
    or (E, 3), all on one device.

    Returns (pos_ecef (E, 3), cov (E, 3, 3), ok (E,), n_dd (E,)).
    """
    E, M = valid.shape
    dtype, dev = sat_pos.dtype, sat_pos.device
    # DD pairing masks and weights, once (state-independent).
    pair_mask, master_of = _pair_structure(valid, system, master)
    zero = torch.zeros((), dtype=dtype, device=dev)
    w = torch.where(pair_mask, 1.0 / elesnr_var(el, snr), zero)
    sd_meas = psr_rov - psr_sta
    dd_meas = sd_meas - sd_meas.gather(1, master_of)
    sig0 = 1.0 / torch.sqrt(torch.clamp(w, min=1e-12))
    rho_r = torch.linalg.norm(sat_pos - station_ecef, dim=-1)
    eye = torch.eye(3, dtype=dtype, device=dev)

    def robust_w(res, k: int):
        """Per-satellite robust reweighting of the goGPS weights."""
        rw = torch.ones_like(w)
        if huber is not None and k >= 2:
            t = torch.abs(res) / torch.clamp(huber * sig0, min=1e-9)
            rw = torch.where(t > 1.0, 1.0 / t, rw)
        if trim is not None and k >= 4:
            rw = torch.where(torch.abs(res) > trim, zero, rw)
        return w * rw

    def residuals(x):
        d = sat_pos - x[:, None, :]
        rho_u = torch.linalg.norm(d, dim=-1)
        sd_est = rho_u - rho_r
        dd_est = sd_est - sd_est.gather(1, master_of)
        res = torch.where(pair_mask, dd_meas - dd_est, zero)
        los = -d / torch.clamp(rho_u, min=1.0)[..., None]
        return res, los - los.gather(1, master_of[..., None].expand(-1, -1, 3))

    def normal_eq(res, A, wk):
        Aw = A * wk[..., None]
        return torch.einsum("emi,emj->eij", Aw, A) + 1e-9 * eye, torch.einsum("emi,em->ei",
                                                                               Aw, res)

    x = torch.as_tensor(x0, dtype=dtype, device=dev).expand(E, 3)
    for k in range(iters):
        res, A = residuals(x)
        H, g = normal_eq(res, A, robust_w(res, k))
        x = x + spd_solve(H, g)

    # Final residuals and covariance, at the converged robust weights.
    res, A = residuals(x)
    wf = robust_w(res, iters)
    H, _ = normal_eq(res, A, wf)
    n_dd = pair_mask.sum(dim=1)
    n_eff = (wf > 0).sum(dim=1)
    dof = torch.clamp(n_eff - 3, min=1)
    s2 = torch.sum(res * res * wf, dim=1) / dof
    cov = s2[:, None, None] * spd_solve(H, eye.expand(E, 3, 3))
    ok = (n_eff >= 4) & torch.isfinite(x).all(dim=1) & (torch.sqrt(s2) < 100.0)
    return x, cov, ok, n_dd


def solve_epoch_dd(sat_pos, psr_rov, psr_sta, valid, system, master, station_ecef,
                   el, snr, x0, iters: int = 8, huber: float | None = None,
                   trim: float | None = None):
    """One epoch's DD fix: the arrays of ``solve_epochs_dd`` without the
    epoch axis. Returns (pos_ecef (3,), cov (3, 3), ok (), n_dd ())."""
    out = solve_epochs_dd(sat_pos[None], psr_rov[None], psr_sta[None], valid[None],
                          system[None], master[None], station_ecef, el[None], snr[None],
                          x0, iters=iters, huber=huber, trim=trim)
    return tuple(a[0] for a in out)


# --- carrier-phase float filter (rtkpos parity) ----------------------------------

class FloatFilterOut(NamedTuple):
    pos: torch.Tensor      # (E, 3) ECEF
    vel: torch.Tensor      # (E, 3) ECEF
    pos_cov: torch.Tensor  # (E, 3, 3) inflated by ``consist`` and the code floor
    amb: torch.Tensor      # (E, M) SD float ambiguities (m)
    amb_var: torch.Tensor  # (E, M) their diagonal variance
    ok: torch.Tensor       # (E,) enough DDs and finite
    n_dd: torch.Tensor     # (E,) code DD count
    n_car: torch.Tensor    # (E,) carrier DD count
    amb_cov: torch.Tensor  # (E, M, M) full SD-ambiguity covariance
    pa_cov: torch.Tensor   # (E, 3, M) position × ambiguity cross-covariance
    consist: torch.Tensor = None  # (E,) smoothed code chi-square ratio (≥ 1)


def arc_tracking(gnss, max_gap: float = 2.5, dopp_jump: float = 5.0):
    """Host-side cycle-slip / arc segmentation (RTKLIB ``detslp_ll`` role).

    Returns (prev_slot (E, M) int32, slip (E, M) bool): prev_slot[k, m] is
    the slot of the same satellite at epoch k−1 (−1 if absent); slip marks
    the start of a new carrier arc — LLI bit 0, a tracking gap, a
    carrier-vs-Doppler prediction jump, or missing carrier.
    """
    E, M = gnss.valid.shape
    prev_slot = np.full((E, M), -1, np.int32)
    slip = np.ones((E, M), bool)
    sat_id = np.asarray(gnss.sat_id)
    car_ok = np.asarray(gnss.car_valid) & np.asarray(gnss.valid)
    car = np.asarray(gnss.car_rov)
    dopp = np.asarray(gnss.dopp_rov)
    t = np.asarray(gnss.time)
    prev_map = {}
    prev_t = None
    for k in range(E):
        cur_map = {}
        for m in range(M):
            sid = sat_id[k, m]
            if sid < 0 or not gnss.valid[k, m]:
                continue
            cur_map[int(sid)] = m
            pm = prev_map.get(int(sid), -1)
            prev_slot[k, m] = pm
            if not car_ok[k, m]:
                continue
            if pm < 0 or prev_t is None:
                continue
            if int(np.asarray(gnss.lli)[k, m]) & 1:
                continue
            dt = t[k] - prev_t
            if dt > max_gap or not car_ok[k - 1, pm]:
                continue
            # Doppler consistency: dopp_rov is stored as range-rate (m/s)
            # and carrier grows with range, so Δcar ≈ +range_rate·dt
            # (trapezoid over the interval).
            pred = 0.5 * (dopp[k, m] + dopp[k - 1, pm]) * dt
            if abs((car[k, m] - car[k - 1, pm]) - pred) > dopp_jump:
                continue
            slip[k, m] = False
        prev_map = cur_map
        prev_t = t[k]
    return prev_slot, slip


def _nanmedian(x, mask):
    """``jnp.nanmedian`` of x over its last axis where ``mask``: the two
    middle values of an even count averaged by linear interpolation, as
    JAX does (``torch.nanmedian`` takes the lower one); NaN where none."""
    v = torch.where(mask, x, torch.full_like(x, float("nan")))
    n = (~torch.isnan(v)).sum(dim=-1, keepdim=True).to(x.dtype)
    srt = torch.sort(v, dim=-1)[0]
    q = 0.5 * (n - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    w_high = q - low
    idx = lambda v: torch.clamp(torch.minimum(v, n - 1.0), min=0.0).long()
    return (srt.gather(-1, idx(low)) * (1.0 - w_high)
            + srt.gather(-1, idx(high)) * w_high)[..., 0]


def float_filter(sat_pos, sat_vel, sat_ddt, psr_rov, psr_sta, car_rov, car_sta, car_valid,
                 dopp_rov, valid, system, master, elevation, snr, prev_slot, slip, times,
                 station_ecef, x0, accel_sigma: float = 2.0, code_huber: float = 2.0,
                 car_huber: float = 4.0, eratio: float = 100.0, innov_gate: float = 6.0,
                 consist_alpha: float = 0.05) -> FloatFilterOut:
    """Forward float-RTK Kalman filter over the whole mission.

    Epoch tensors are (E, M) / (E, M, 3) on one device, f64 where real;
    ``x0`` (3,) is the cold-start ECEF position. State [p(3), v(3),
    SD-ambiguity(M)] with slot-remapped arcs; each epoch predicts, re-maps
    the ambiguity slots through ``prev_slot`` (absent satellites and fresh
    arcs restart at variance 1e4 m², uncorrelated), gates every code and
    carrier row by its predicted innovation (|ν| > ``innov_gate`` rejected,
    Huber between) and updates in information form. Returns FloatFilterOut.
    """
    E, M = valid.shape
    N = 6 + M
    dev = sat_pos.device
    F64 = torch.float64
    BIG = 1e4          # variance of a fresh ambiguity (m^2)
    PHI_RW = 1e-6      # per-step ambiguity random walk (m^2)
    OMGE, CL = 7.2921151467e-5, 299792458.0
    zero = torch.zeros((), dtype=F64, device=dev)
    eye3 = torch.eye(3, dtype=F64, device=dev)
    eyeN = torch.eye(N, dtype=F64, device=dev)

    # --- everything that does not depend on the state, all epochs at once.
    prev_slot = prev_slot.long()
    pair_mask, master_of = _pair_structure(valid, system, master)
    mo3 = master_of[..., None].expand(E, M, 3)
    take = lambda a: a.gather(1, master_of)
    dts = torch.zeros(E, dtype=F64, device=dev)
    dts[1:] = torch.clamp(times[1:] - times[:-1], 0.0, 10.0)
    idx = torch.where(prev_slot >= 0, prev_slot, torch.full_like(prev_slot, M))
    gidx = torch.cat([torch.arange(6, device=dev).expand(E, 6), 6 + idx], dim=1)   # (E, N)
    sd_psr = psr_rov - psr_sta
    sd_car = torch.where(car_valid, car_rov - car_sta, zero)
    fresh = slip & car_valid & valid
    a_init = sd_car - sd_psr
    fresh_m = fresh | (idx == M)
    keep_n = torch.cat([torch.ones((E, 6), dtype=torch.bool, device=dev), ~fresh_m], 1).to(F64)
    rho_r = torch.linalg.norm(sat_pos - station_ecef, dim=-1)
    dd_psr = sd_psr - take(sd_psr)
    dd_car = sd_car - take(sd_car)
    m_code = pair_mask
    cok_pair = car_valid & take(car_valid.long()).bool() & pair_mask
    H_amb = (torch.eye(M, dtype=F64, device=dev)
             - torch.nn.functional.one_hot(master_of, M).to(F64))      # (E, M, M)
    sig_code = torch.sqrt(elesnr_var(elevation, snr) + elesnr_var(take(elevation), take(snr)))
    w_code0 = torch.where(m_code, 1.0 / sig_code, zero)
    w_car0 = torch.where(cok_pair, eratio / sig_code, zero)
    n_dd = m_code.sum(dim=1)
    n_car = cok_pair.sum(dim=1)
    code_ok = n_dd >= 4
    upd = torch.where(code_ok, torch.full_like(dts, consist_alpha), zero)
    wd = valid.to(F64)
    nd = torch.clamp(wd.sum(dim=1), min=1.0)
    w_dop0 = torch.where(valid, torch.full_like(wd, 1.0 / 0.5), zero)

    def innov_nu(Hrows, res, sig_meas, mask, P):
        s = torch.sqrt(torch.clamp(torch.sum((Hrows @ P) * Hrows, dim=1), min=0.0)
                       + sig_meas ** 2)
        return torch.where(mask, res / torch.clamp(s, min=1e-12), zero)

    def robust_factor(nu, huber):
        f = torch.clamp(huber / torch.clamp(torch.abs(nu), min=1e-9), max=1.0)
        return torch.where(torch.abs(nu) > innov_gate, zero, f)

    # --- the state.
    x = torch.zeros(N, dtype=F64, device=dev)
    x[:3] = torch.as_tensor(x0, dtype=F64, device=dev)
    P = eyeN * BIG
    P[:3, :3] = eye3 * 1e4
    P[3:6, 3:6] = eye3 * 1e2
    c_ema = torch.ones((), dtype=F64, device=dev)
    b_ema = torch.zeros(3, dtype=F64, device=dev)
    dp_prev = torch.zeros(3, dtype=F64, device=dev)
    C_ema = torch.zeros((3, 3), dtype=F64, device=dev)
    num_ema = torch.zeros((), dtype=F64, device=dev)
    den_ema = torch.zeros((), dtype=F64, device=dev)
    q_acc = accel_sigma ** 2
    outs = []
    for k in range(E):
        dt = dts[k]
        # --- predict.
        F = eyeN.clone()
        F[:3, 3:6] = eye3 * dt
        Qpv = torch.zeros((6, 6), dtype=F64, device=dev)
        Qpv[:3, :3] = eye3 * (q_acc * dt ** 3 / 3.0 + 1e-8)
        Qpv[:3, 3:] = eye3 * (q_acc * dt ** 2 / 2)
        Qpv[3:, :3] = eye3 * (q_acc * dt ** 2 / 2)
        Qpv[3:, 3:] = eye3 * (q_acc * dt + 1e-8)
        P = F @ P @ F.T
        P[:6, :6] += Qpv
        P[6:, 6:] += PHI_RW * eyeN[6:, 6:]
        x = torch.cat([x[:3] + x[3:6] * dt, x[3:]])

        # --- re-map the ambiguity slots to this epoch's satellites (M is the
        # pad slot: zero state, zero covariance).
        a_new = torch.cat([x[6:], zero[None]])[idx[k]]
        Ppad = torch.nn.functional.pad(P, (0, 1, 0, 1))
        P = Ppad.index_select(0, gidx[k]).index_select(1, gidx[k])
        # --- fresh arcs start from code-minus-carrier, uncorrelated, at BIG.
        x = torch.cat([x[:6], torch.where(fresh[k], a_init[k], a_new)])
        P = P * keep_n[k][:, None] * keep_n[k][None, :]
        P.diagonal()[6:] = torch.where(fresh_m[k], torch.full_like(a_new, BIG),
                                       P.diagonal()[6:])

        # --- measurement geometry.
        spos = sat_pos[k]
        d = spos - x[:3]
        rho_u = torch.linalg.norm(d, dim=-1)
        los = -d / torch.clamp(rho_u, min=1.0)[:, None]
        mo = master_of[k]
        sd_geom = rho_u - rho_r[k]
        dd_geom = sd_geom - sd_geom[mo]
        dlos = los - los[mo]
        res_code = dd_psr[k] - dd_geom
        amb = x[6:]
        res_car = dd_car[k] - dd_geom - (amb - amb[mo])
        H_code = torch.cat([dlos, torch.zeros((M, N - 3), dtype=F64, device=dev)], 1)
        H_car = torch.cat([dlos, torch.zeros((M, 3), dtype=F64, device=dev), H_amb[k]], 1)

        nu_c = innov_nu(H_code, res_code, sig_code[k], m_code[k], P)
        nu_p = innov_nu(H_car, res_car, sig_code[k] / eratio, cok_pair[k], P)
        w_code = w_code0[k] * robust_factor(nu_c, code_huber)
        w_car = w_car0[k] * robust_factor(nu_p, car_huber)

        # Per-epoch robust code chi-square ratio, EMA-smoothed.
        chi_ratio = _nanmedian(nu_c ** 2, m_code[k]) / 0.455
        chi_ratio = torch.where(torch.isfinite(chi_ratio) & code_ok[k], chi_ratio,
                                torch.ones_like(chi_ratio))
        c_ema = (1.0 - consist_alpha) * c_ema + consist_alpha * chi_ratio

        # Position-domain code discrepancy and its correlation-adjusted floor.
        Ac = dlos * w_code[:, None]
        Nc = Ac.T @ Ac + 1e-2 * eye3
        dp_code = spd_solve(Nc, Ac.T @ (res_code * w_code))
        dp_code = torch.where(code_ok[k], dp_code, torch.zeros_like(dp_code))
        b_ema = (1.0 - consist_alpha) * b_ema + consist_alpha * dp_code
        u = upd[k]
        C_ema = (1.0 - u) * C_ema + u * torch.outer(dp_code, dp_code)
        num_ema = (1.0 - u) * num_ema + u * torch.dot(dp_code, dp_prev)
        den_ema = (1.0 - u) * den_ema + u * torch.dot(dp_code, dp_code)
        dp_prev = torch.where(code_ok[k], dp_code, dp_prev)
        rho = torch.clamp(num_ema / torch.clamp(den_ema, min=1e-12), 0.0, 0.95)
        tau_corr = (1.0 + rho) / (1.0 - rho)
        floor = C_ema * torch.clamp(tau_corr * consist_alpha, max=1.0)

        # Doppler rows, the receiver clock drift eliminated in closed form.
        svel = sat_vel[k]
        sag = OMGE / CL * (svel[:, 0] * x[1] + spos[:, 0] * x[4]
                           - svel[:, 1] * x[0] - spos[:, 1] * x[3])
        dop_est = torch.sum((svel - x[3:6]) * (-los), dim=-1) + sag - sat_ddt[k]
        a_row = dopp_rov[k] - dop_est
        wdk = wd[k]
        res_dop = torch.where(valid[k], a_row - torch.sum(wdk * a_row) / nd[k], zero)
        H_dop_v = (los - torch.sum(los * wdk[:, None], 0) / nd[k]) * wdk[:, None]
        w_dop = w_dop0[k]
        zd = res_dop * w_dop
        w_dop = w_dop * torch.clamp(3.0 / torch.clamp(torch.abs(zd), min=1e-9), max=1.0)
        H_dop = torch.cat([torch.zeros((M, 3), dtype=F64, device=dev), H_dop_v,
                           torch.zeros((M, M), dtype=F64, device=dev)], 1)

        # --- information-form update.
        H = torch.cat([H_code * w_code[:, None], H_car * w_car[:, None],
                       H_dop * w_dop[:, None]], 0)
        r = torch.cat([res_code * w_code, res_car * w_car, res_dop * w_dop])
        Lam = spd_solve(P + 1e-9 * eyeN, eyeN)
        Lam = 0.5 * (Lam + Lam.T) + H.T @ H
        x = x + spd_solve(Lam, H.T @ r)
        P = spd_solve(Lam, eyeN)
        P = 0.5 * (P + P.T)

        ok = code_ok[k] & torch.isfinite(x[:6]).all()
        infl = torch.clamp(c_ema, min=1.0)
        cov_rep = (P[:3, :3] + torch.outer(b_ema, b_ema)) * infl + floor
        outs.append((x[:3], x[3:6], cov_rep, x[6:], torch.diagonal(P)[6:], ok, P[6:, 6:],
                     P[:3, 6:], infl))
    st = [torch.stack(a) for a in zip(*outs)]
    return FloatFilterOut(pos=st[0], vel=st[1], pos_cov=st[2], amb=st[3], amb_var=st[4],
                          ok=st[5], n_dd=n_dd, n_car=n_car, amb_cov=st[6], pa_cov=st[7],
                          consist=st[8])


def run_float_filter(gnss, station_ecef, x0, *, device="cuda", **kw) -> FloatFilterOut:
    """GnssEpochs → FloatFilterOut on ``device``: arc tracking on the host,
    then ``float_filter``. Without carrier the carrier rows are off; without
    ``sat_id`` every satellite starts a fresh arc at every epoch."""
    E, M = gnss.valid.shape
    if gnss.car_rov is None:
        car_rov = np.zeros((E, M))
        car_sta = np.zeros((E, M))
        car_ok = np.zeros((E, M), bool)
    else:
        car_rov, car_sta, car_ok = gnss.car_rov, gnss.car_sta, gnss.car_valid
    prev_slot, slip = (arc_tracking(gnss) if gnss.sat_id is not None
                       else (np.full((E, M), -1, np.int32), np.ones((E, M), bool)))
    dev = torch.device(device)
    f = lambda a: torch.as_tensor(np.asarray(a, float), dtype=torch.float64, device=dev)
    i = lambda a, dt=torch.int64: torch.as_tensor(np.asarray(a), device=dev).to(dt)
    b = lambda a: i(a, torch.bool)
    return float_filter(f(gnss.sat_pos), f(gnss.sat_vel), f(gnss.sat_ddt), f(gnss.psr_rov),
                        f(gnss.psr_sta), f(car_rov), f(car_sta), b(car_ok), f(gnss.dopp_rov),
                        b(gnss.valid), i(gnss.system), i(gnss.master), f(gnss.elevation),
                        f(gnss.snr), i(prev_slot), b(slip), f(gnss.time), f(station_ecef),
                        f(x0), **kw)
