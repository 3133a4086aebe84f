"""Per-epoch RTK double-difference position fixes (port of ``glio_tpu/gnss/rtk.py:37-131``).

The code-only DD Gauss-Newton fix that stage 3 gates on covariance
(Estimator.cpp:1963-1969) and that backend fusion's divergence gate uses as
an independent absolute position. ``solve_epochs_dd`` solves every epoch
at once over a leading epoch axis; ``solve_epoch_dd`` is the one-epoch
case. Weights are the inverse goGPS variance of the non-master satellite;
``huber`` (sigma multiples, from iteration 2) and ``trim`` (metres, from
iteration 4) reweight per satellite. The iteration count is fixed and
nothing waits on the host. The carrier-phase float filter is not ported.
"""

import torch

from ..solver.linalg import spd_solve
from .dd import elesnr_var


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
    system = system.long()
    master = master.long()
    slot = torch.arange(M, device=dev)

    # DD pairing masks and weights, once (state-independent).
    pair_mask = torch.zeros((E, M), dtype=torch.bool, device=dev)
    master_of = torch.zeros((E, M), dtype=torch.int64, device=dev)
    for s in range(master.shape[1]):
        mp = master[:, s:s + 1]
        mp_safe = torch.clamp(mp, min=0)
        m = valid & (system == s) & (slot != mp_safe) & (mp >= 0)
        pair_mask = pair_mask | m
        master_of = torch.where(m, mp_safe, master_of)

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
