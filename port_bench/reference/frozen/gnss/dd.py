"""Double-difference pseudorange formation and whitening (port of ``glio_tpu/gnss/dd.py``).

Per constellation the highest-elevation satellite is the master, and the
(n−1) DD residuals of an epoch are whitened with R = ((D W⁻¹ Dᵀ)∘½)⁻¹, D the
difference operator and W the goGPS elevation/SNR weights
(``cofactorMatrixCal_WLS``, gnss_tools.h:1177-1226). The reference takes
the element-wise square root of D W⁻¹ Dᵀ before inverting (``cwiseSqrt``),
not a matrix square root; so does this module.

``elesnr_var_np``, ``select_master``, ``dd_whitening_matrix`` and
``bind_epochs_to_keyframes`` are host numpy, copied from the JAX package;
``elesnr_var`` is the torch twin of the variance for the device (``gnss.spp``
takes it from here). ``dd_residual`` is torch and takes any number of
leading (epoch) axes.
"""

import numpy as np
import torch


def elesnr_var_np(el, snr):
    """goGPS elevation/SNR variance (``spp.elesnr_var``), numpy, any shape."""
    T, A, a, F = 50.0, 30.0, 30.0, 10.0
    q1 = 1.0 / np.maximum(np.sin(el) ** 2, 1e-4)
    q2 = 10.0 ** (-(snr - T) / a)
    q3 = ((A / (10.0 ** (-(F - T) / a)) - 1.0) / (F - T)) * (snr - T) + 1.0
    return q1 * (q2 * q3)


def _elesnr_var_scalar(el, snr):
    return float(elesnr_var_np(np.asarray(el), np.asarray(snr)))


def select_master(elevation, valid, system, n_sys: int = 4):
    """Highest-elevation valid satellite per constellation → (n_sys,) slots,
    −1 where a system has fewer than 3 usable satellites
    (Estimator.cpp:3202)."""
    elevation = np.asarray(elevation)
    valid = np.asarray(valid)
    system = np.asarray(system)
    out = np.full(n_sys, -1, np.int32)
    for s in range(n_sys):
        m = valid & (system == s)
        if m.sum() < 3:
            continue
        out[s] = int(np.argmax(np.where(m, elevation, -np.inf)))
    return out


def dd_whitening_matrix(elevation, snr, valid, system, master, max_sv: int):
    """Per-system DD whitening matrices over the padded slots, numpy.

    Returns (n_sys, max_sv, max_sv) W such that the whitened DD residual of
    system s is W[s] @ r_s, with r_s[i] the DD residual of slot i against
    the system's master (zero for masked slots).
    """
    elevation = np.asarray(elevation)
    snr = np.asarray(snr)
    valid = np.asarray(valid)
    system = np.asarray(system)
    n_sys = master.shape[0]
    out = np.zeros((n_sys, max_sv, max_sv))
    for s in range(n_sys):
        mp = int(master[s])
        if mp < 0:
            continue
        slots = [i for i in range(max_sv)
                 if valid[i] and system[i] == s and i != mp]
        if not slots:
            continue
        n = len(slots)
        # W⁻¹ = diag of the variances of [slots..., master] (master last).
        var = np.array([_elesnr_var_scalar(float(elevation[i]), float(snr[i]))
                        for i in slots + [mp]])
        D = np.zeros((n, n + 1))
        D[:, :n] = np.eye(n)
        D[:, n] = -1.0
        cov = D @ np.diag(var) @ D.T
        R = np.linalg.inv(np.sqrt(cov))  # element-wise sqrt, then inverse
        out[s][np.ix_(slots, slots)] = R
    return out


def dd_residual(p_ecef, sat_pos, psr_rov, psr_sta, station_pos, valid, system,
                master, whiten, threshold=1e9):
    """Whitened DD pseudorange residuals (``dd_psr_factor_20::Evaluate``).

    DD_est = (|s_i − p| − |s_i − sta|) − (|s_m − p| − |s_m − sta|),
    DD_meas = (P_u,i − P_r,i) − (P_u,m − P_r,m), r_i = DD_est − DD_meas,
    down-weighted ×0.05 beyond ``threshold``, then whitened per system.

    Shapes, with any leading axes (...): p_ecef (..., 3); sat_pos (..., M, 3);
    psr_rov, psr_sta, valid, system (..., M); station_pos (3,); master
    (..., n_sys); whiten (..., n_sys, M, M). Returns (..., n_sys, M).
    """
    rho_u = torch.linalg.norm(sat_pos - p_ecef[..., None, :], dim=-1)
    rho_r = torch.linalg.norm(sat_pos - station_pos, dim=-1)
    sd_est = rho_u - rho_r
    sd_meas = psr_rov - psr_sta
    idx = torch.arange(sd_est.shape[-1], device=sd_est.device)
    res = []
    for s in range(master.shape[-1]):
        mp = master[..., s:s + 1]
        mp_safe = torch.clamp(mp, min=0).long()
        dd_est = sd_est - sd_est.gather(-1, mp_safe)
        dd_meas = sd_meas - sd_meas.gather(-1, mp_safe)
        r = dd_est - dd_meas
        m = valid & (system == s) & (idx != mp_safe) & (mp >= 0)
        r = torch.where(m, r, torch.zeros_like(r))
        # Annealed outlier down-weighting (dd_psr_factor.hpp:100-102).
        r = torch.where(torch.abs(r) > threshold, 0.05 * r, r)
        res.append((whiten[..., s, :, :] @ r[..., None])[..., 0])
    return torch.stack(res, dim=-2)


def bind_epochs_to_keyframes(gnss, kf_time, max_sv: int):
    """Per-keyframe GNSS binding for the sliding window (host numpy).

    For each keyframe k, the latest epoch inside (t_{k-1}, t_k] with its
    interpolation ratio toward k-1 (dd_psr_factor.hpp:42) and its whitening.
    Returns a dict of (T, ...) arrays, the ``GnssKfData`` fields with a
    ``gnss_`` prefix.
    """
    kf_time = np.asarray(kf_time, float)
    T = kf_time.shape[0]
    M = max_sv
    out = dict(
        gnss_sat_pos=np.zeros((T, M, 3)),
        gnss_psr_rov=np.zeros((T, M)),
        gnss_psr_sta=np.zeros((T, M)),
        gnss_sv_valid=np.zeros((T, M), bool),
        gnss_system=np.zeros((T, M), np.int32),
        gnss_master=np.full((T, 4), -1, np.int32),
        gnss_whiten=np.zeros((T, 4, M, M)),
        gnss_ratio=np.full((T,), 0.5),
        gnss_valid=np.zeros((T,), bool),
        gnss_sat_vel=np.zeros((T, M, 3)),
        gnss_sat_ddt=np.zeros((T, M)),
        gnss_dopp=np.zeros((T, M)),
        gnss_dopp_valid=np.zeros((T, M), bool),
        gnss_dopp_std=np.ones((T, M)),
    )
    if gnss is None:
        return out
    # side="right": an epoch exactly at kf_time[k] binds to interval k, the
    # half-open (t_{k-1}, t_k]; with side="left" it would be dropped.
    idx = np.searchsorted(gnss.time, kf_time, side="right")
    for k in range(1, T):
        cand = idx[k] - 1              # the latest epoch within the interval
        if cand < 0:
            continue
        te = gnss.time[cand]
        if te <= kf_time[k - 1] or te > kf_time[k]:
            continue
        dt = kf_time[k] - kf_time[k - 1]
        out["gnss_sat_pos"][k] = gnss.sat_pos[cand]
        out["gnss_psr_rov"][k] = gnss.psr_rov[cand]
        out["gnss_psr_sta"][k] = gnss.psr_sta[cand]
        out["gnss_sv_valid"][k] = gnss.valid[cand]
        out["gnss_system"][k] = gnss.system[cand]
        out["gnss_master"][k] = gnss.master[cand]
        out["gnss_whiten"][k] = dd_whitening_matrix(
            gnss.elevation[cand], gnss.snr[cand], gnss.valid[cand],
            gnss.system[cand], gnss.master[cand], M)
        out["gnss_ratio"][k] = (kf_time[k] - te) / max(dt, 1e-9)
        out["gnss_valid"][k] = True
        # The Doppler channel of the tcdopplerFactor rows. The sigma is the
        # reference's: weight = Doppler2PSRWeight(0.1) · W_goGPS, so the
        # residual is divided by sqrt(10·var_elesnr) (Estimator.cpp:71,2288,2330).
        out["gnss_sat_vel"][k] = gnss.sat_vel[cand]
        out["gnss_sat_ddt"][k] = gnss.sat_ddt[cand]
        out["gnss_dopp"][k] = gnss.dopp_rov[cand]
        out["gnss_dopp_valid"][k] = gnss.valid[cand] & (gnss.dopp_rov[cand] != 0.0)
        var = np.array([_elesnr_var_scalar(float(e), float(s))
                        for e, s in zip(gnss.elevation[cand], gnss.snr[cand])])
        out["gnss_dopp_std"][k] = np.sqrt(10.0 * np.maximum(var, 1e-6))
    return out
