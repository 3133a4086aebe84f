"""Single point positioning and Doppler velocity, batched over epochs (port of ``glio_tpu/gnss/spp.py``).

The reference's ``GNSS_Tools`` WLS solver (``gnss_tools.h:588-870``):
per-constellation receiver clocks, Gauss-Newton, and the goGPS
elevation/SNR variance model (``eleSRNVar``). The JAX package ``vmap``s one
epoch's solve over a sequence; here every function takes a leading epoch
axis and solves all epochs at once: one (E, 7, 7) system per Gauss-Newton
iteration, a fixed 8 iterations, no loop over epochs and no host sync.
``doppler_velocity`` is the capability of ``gnss_comm``'s ``dopp_vel``
(gnss_spp.hpp:36-94). ``elesnr_var`` lives in ``gnss.dd``.
"""

import torch

from ..solver.linalg import spd_solve
from ..utils.coords import CLIGHT, OMGE
from .dd import elesnr_var

N_SYS = 4  # GPS, GLO, GAL, BDS

__all__ = ["elesnr_var", "solve_epochs", "solve_epoch", "doppler_velocity"]


def _sagnac(sat_pos, rcv_pos):
    return OMGE / CLIGHT * (sat_pos[..., 0] * rcv_pos[..., 1]
                            - sat_pos[..., 1] * rcv_pos[..., 0])


def solve_epochs(sat_pos, psr_corrected, system, valid, el, snr, x0, iters: int = 8):
    """WLS SPP of every epoch at once.

    Args (leading epoch axes ``...``): sat_pos (..., M, 3) ECEF satellite
    positions; psr_corrected (..., M) pseudorange + sat clock − iono − tropo
    (m); system (..., M) constellation ids 0..3; valid (..., M) bool; el,
    snr (..., M) elevation (rad) and C/N0 for the weights; x0 (3,) or
    (..., 3) initial receiver position.

    Returns (pos (..., 3), clk (..., 4), ok (...), residual_rms (...)). A
    system with no satellites keeps its clock at 0 (the 1e-9 damping).
    """
    dtype, dev = sat_pos.dtype, sat_pos.device
    n_par = 3 + N_SYS
    sys_onehot = torch.nn.functional.one_hot(system.long(), N_SYS).to(dtype)  # (..., M, 4)
    w = torch.where(valid, 1.0 / elesnr_var(el, snr), torch.zeros_like(el))
    eye = 1e-9 * torch.eye(n_par, dtype=dtype, device=dev)
    x = torch.as_tensor(x0, dtype=dtype, device=dev).expand(sat_pos.shape[:-2] + (3,))
    clk = torch.zeros(sat_pos.shape[:-2] + (N_SYS,), dtype=dtype, device=dev)
    for _ in range(iters):
        d = sat_pos - x[..., None, :]
        rho = torch.linalg.norm(d, dim=-1)
        pred = rho + _sagnac(sat_pos, x[..., None, :]) + (sys_onehot @ clk[..., None])[..., 0]
        res = torch.where(valid, psr_corrected - pred, torch.zeros_like(pred))
        los = -d / torch.clamp(rho, min=1.0)[..., None]
        J = torch.cat([los, sys_onehot], dim=-1)                 # (..., M, 7)
        Jw = J * w[..., None]
        H = Jw.mT @ J + eye
        g = (Jw.mT @ res[..., None])[..., 0]
        dx = spd_solve(H, g)
        x = x + dx[..., :3]
        clk = clk + dx[..., 3:]
    # Final residual RMS for quality gating.
    d = sat_pos - x[..., None, :]
    rho = torch.linalg.norm(d, dim=-1) + _sagnac(sat_pos, x[..., None, :])
    res = torch.where(valid, psr_corrected - rho - (sys_onehot @ clk[..., None])[..., 0],
                      torch.zeros_like(rho))
    n = torch.clamp(valid.sum(-1), min=1)
    rms = torch.sqrt(torch.sum(res * res, dim=-1) / n)
    ok = (valid.sum(-1) >= 5) & torch.isfinite(x).all(-1) & (rms < 100.0)
    return x, clk, ok, rms


# One epoch is the case without leading axes.
solve_epoch = solve_epochs


def doppler_velocity(sat_pos, sat_vel, dopp_ms, system, valid, el, snr, rcv_pos):
    """WLS receiver velocity and clock drift from range rates, every epoch
    at once: dopp_ms (..., M) is the measured range rate in m/s (−doppler·λ
    as the converter stores it), rcv_pos (..., 3). One clock drift shared by
    all systems (the released tcdoppler factor, dopp_factor.hpp:38).
    Returns (v (..., 3), ddt (...)). ``system`` is accepted for the JAX
    signature and, as there, not used."""
    d = sat_pos - rcv_pos[..., None, :]
    rho = torch.linalg.norm(d, dim=-1)
    los = d / torch.clamp(rho, min=1.0)[..., None]
    w = torch.where(valid, 1.0 / elesnr_var(el, snr), torch.zeros_like(el))
    # pred = (sv_vel − v)·los + ddt  ⇒ linear in (v, ddt).
    J = torch.cat([-los, torch.ones_like(rho)[..., None]], dim=-1)
    y = dopp_ms - torch.sum(sat_vel * los, dim=-1)
    Jw = J * w[..., None]
    H = Jw.mT @ J + 1e-9 * torch.eye(4, dtype=J.dtype, device=J.device)
    g = (Jw.mT @ torch.where(valid, y, torch.zeros_like(y))[..., None])[..., 0]
    sol = spd_solve(H, g)
    return sol[..., :3], sol[..., 3]
