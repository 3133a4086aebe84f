"""Double-difference pseudorange formation and whitening (port of ``glio_tpu/gnss/dd.py``).

Per constellation the highest-elevation satellite is the master, and the
(n−1) DD residuals of an epoch are whitened with R = ((D W⁻¹ Dᵀ)∘½)⁻¹, D the
difference operator and W the goGPS elevation/SNR weights
(``cofactorMatrixCal_WLS``, gnss_tools.h:1177-1226). The reference takes
the element-wise square root of D W⁻¹ Dᵀ before inverting (``cwiseSqrt``),
not a matrix square root; so does this module.

``elesnr_var_np``, ``select_master`` and ``dd_whitening_matrix`` are host
numpy, copied from the JAX package; ``elesnr_var`` is their torch twin for
the device. ``dd_residual`` is torch and takes any number of leading
(epoch) axes. ``bind_epochs_to_keyframes`` belongs to GNSS in the sliding
window, which is not ported yet.
"""

import numpy as np
import torch


def elesnr_var(el, snr):
    """goGPS elevation/SNR variance (``spp.elesnr_var``), torch, any shape:
    larger is worse."""
    T, A, a, F = 50.0, 30.0, 30.0, 10.0
    q1 = 1.0 / torch.clamp(torch.sin(el) ** 2, min=1e-4)
    q2 = 10.0 ** (-(snr - T) / a)
    q3 = ((A / (10.0 ** (-(F - T) / a)) - 1.0) / (F - T)) * (snr - T) + 1.0
    return q1 * (q2 * q3)


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
