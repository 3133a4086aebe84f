"""IMU preintegration and the whitened IMU factor (port of ``glio_tpu/factors/imu.py``).

Midpoint preintegration of (Δp, Δq, Δv) with the 15×15 Jacobian and
covariance propagation of ``GLIO/include/factors/Preintegration.h:96-235``.
Every function broadcasts over leading axes, so one call serves all the
window's edges. ``preintegrate`` runs by device: on a CUDA device it is one
launch of the kernel ``csrc/imu_preint.cu`` (``ops/imu_preint.py``), a block
an edge; elsewhere, the CPU included, it is ``preintegrate_reference``, a
Python loop over the samples of the padded buffer with the edges as the
batch, which is the kernel's plain version. Each call adds one to the tally
``imu.preintegrate.kernel`` or ``imu.preintegrate.loop``
(``utils.profiling.tallies``). The propagation runs in f64 throughout; the
JAX package's f32 associative-scan fast path is a TPU workaround for
emulated f64 and has no counterpart here.
"""

from typing import NamedTuple

import torch

from ..ops import imu_preint
from ..solver.linalg import cholesky_or_nan
from ..utils import profiling, quat, so3

STATE_DIM = 15  # δp(3) δθ(3) δv(3) δba(3) δbg(3)
NOISE_DIM = 18  # acc_n(i), gyr_n(i), acc_n(j), gyr_n(j), acc_w, gyr_w
O_P, O_R, O_V, O_BA, O_BG = 0, 3, 6, 9, 12
F64 = torch.float64


class ImuParams(NamedTuple):
    """Noise densities (config_urban_hk.yaml:5-11, Xsens MTi-10)."""
    acc_n: float = 3.9939570888238808e-03
    gyr_n: float = 1.5636343949698187e-03
    acc_w: float = 6.4356659353532566e-05
    gyr_w: float = 3.5640318696367613e-05
    gravity: float = 9.80511

    def gravity_vec(self, device=None):
        return torch.tensor([0.0, 0.0, self.gravity], dtype=F64, device=device)

    def noise_cov(self, device=None):
        """18×18 diagonal noise block (acc_n, gyr_n at i and j, acc_w, gyr_w)."""
        d = torch.tensor(
            [self.acc_n**2] * 3 + [self.gyr_n**2] * 3 +
            [self.acc_n**2] * 3 + [self.gyr_n**2] * 3 +
            [self.acc_w**2] * 3 + [self.gyr_w**2] * 3, dtype=F64, device=device)
        return torch.diag(d)


class Preintegrated(NamedTuple):
    """Result of preintegrating one keyframe interval (leading axes batch)."""
    delta_p: torch.Tensor      # (..., 3)
    delta_q: torch.Tensor      # (..., 4) wxyz
    delta_v: torch.Tensor      # (..., 3)
    jacobian: torch.Tensor     # (..., 15, 15)
    covariance: torch.Tensor   # (..., 15, 15)
    sum_dt: torch.Tensor       # (...,)
    lin_ba: torch.Tensor       # (..., 3) bias linearization point
    lin_bg: torch.Tensor       # (..., 3)


def _blocks(rows):
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def _fv_matrices(q, q_new, a0, a1, un_gyr, dt, ba):
    """Per-step F (..., 15, 15) and V (..., 15, 18), Preintegration.h:118-166."""
    R0 = quat.to_rotmat(q)
    R1 = quat.to_rotmat(q_new)
    Z = torch.zeros_like(R0)
    I3 = torch.eye(3, dtype=R0.dtype, device=R0.device).expand_as(R0)
    R0a0x = R0 @ so3.hat(a0 - ba)
    R1a1x = R1 @ so3.hat(a1 - ba)
    dtj = dt[..., None, None]
    rot_tx = I3 - so3.hat(un_gyr) * dtj

    F = _blocks([
        [I3, -0.25 * R0a0x * dtj * dtj + -0.25 * R1a1x @ rot_tx * dtj * dtj,
         I3 * dtj, -0.25 * (R0 + R1) * dtj * dtj,
         0.25 * R1a1x * dtj * dtj * dtj],
        [Z, rot_tx, Z, Z, -I3 * dtj],
        [Z, -0.5 * R0a0x * dtj + -0.5 * R1a1x @ rot_tx * dtj, I3,
         -0.5 * (R0 + R1) * dtj, 0.5 * R1a1x * dtj * dtj],
        [Z, Z, Z, I3, Z],
        [Z, Z, Z, Z, I3],
    ])
    V = _blocks([
        [0.25 * R0 * dtj * dtj, -0.125 * R1a1x * dtj * dtj * dtj,
         0.25 * R1 * dtj * dtj, -0.125 * R1a1x * dtj * dtj * dtj, Z, Z],
        [Z, 0.5 * I3 * dtj, Z, 0.5 * I3 * dtj, Z, Z],
        [0.5 * R0 * dtj, -0.25 * R1a1x * dtj * dtj, 0.5 * R1 * dtj,
         -0.25 * R1a1x * dtj * dtj, Z, Z],
        [Z, Z, Z, Z, I3 * dtj, Z],
        [Z, Z, Z, Z, Z, I3 * dtj],
    ])
    return F, V


def preintegrate(acc, gyr, dt, valid, ba, bg, acc0, gyr0,
                 noise_cov) -> Preintegrated:
    """Preintegrate padded IMU sample runs: the kernel on a CUDA device,
    ``preintegrate_reference`` elsewhere (the same arguments and result)."""
    if acc.is_cuda:
        profiling.tally("imu.preintegrate.kernel")
        out = imu_preint.preintegrate(acc, gyr, dt, valid, ba, bg, acc0, gyr0, noise_cov)
        return Preintegrated(*out, ba.to(F64), bg.to(F64))
    profiling.tally("imu.preintegrate.loop")
    return preintegrate_reference(acc, gyr, dt, valid, ba, bg, acc0, gyr0, noise_cov)


def preintegrate_reference(acc, gyr, dt, valid, ba, bg, acc0, gyr0,
                           noise_cov) -> Preintegrated:
    """Preintegrate padded IMU sample runs, one sample slot at a time.

    Args:
      acc, gyr: (..., N, 3) samples (body frame, m/s², rad/s).
      dt: (..., N) per-sample integration intervals.
      valid: (..., N) bool; padded entries are identity steps.
      ba, bg: (..., 3) bias linearization points.
      acc0, gyr0: (..., 3) the sample at the interval start.
      noise_cov: (18, 18) f64 noise block, ``ImuParams.noise_cov()``.

    The covariance starts at 1e-3·I, as in Preintegration.h:56.
    """
    acc, gyr, dt = acc.to(F64), gyr.to(F64), dt.to(F64)
    ba, bg = ba.to(F64), bg.to(F64)
    batch = acc.shape[:-2]
    dev = acc.device
    p = torch.zeros(batch + (3,), dtype=F64, device=dev)
    v = torch.zeros_like(p)
    q = torch.zeros(batch + (4,), dtype=F64, device=dev)
    q[..., 0] = 1.0
    eye = torch.eye(STATE_DIM, dtype=F64, device=dev)
    jac = eye.expand(batch + (STATE_DIM, STATE_DIM))
    cov = 1e-3 * jac
    sum_dt = torch.zeros(batch, dtype=F64, device=dev)
    a_prev, g_prev = acc0.to(F64), gyr0.to(F64)

    for n in range(acc.shape[-2]):
        a1, g1, h, ok = acc[..., n, :], gyr[..., n, :], dt[..., n], valid[..., n]
        hv = h[..., None]
        un_gyr = 0.5 * (g_prev + g1) - bg
        q_new = quat.normalize(quat.mul(q, quat.delta_q(un_gyr * hv)))
        un_acc = 0.5 * (quat.rotate(q, a_prev - ba) + quat.rotate(q_new, a1 - ba))
        p_new = p + v * hv + 0.5 * un_acc * hv * hv
        v_new = v + un_acc * hv
        F, V = _fv_matrices(q, q_new, a_prev, a1, un_gyr, h, ba)
        jac_new = F @ jac
        cov_new = F @ cov @ F.mT + V @ noise_cov @ V.mT

        m = ok.to(F64)
        mv, mm = m[..., None], m[..., None, None]
        p = mv * p_new + (1 - mv) * p
        q = torch.where(ok[..., None], q_new, q)
        v = mv * v_new + (1 - mv) * v
        jac = mm * jac_new + (1 - mm) * jac
        cov = mm * cov_new + (1 - mm) * cov
        sum_dt = m * (sum_dt + h) + (1 - m) * sum_dt
        a_prev = torch.where(ok[..., None], a1, a_prev)
        g_prev = torch.where(ok[..., None], g1, g_prev)
    return Preintegrated(p, q, v, jac, cov, sum_dt, ba, bg)


def _matvec(M, x):
    return (M @ x[..., None])[..., 0]


def bias_corrected_delta(pre: Preintegrated, ba_i, bg_i):
    """First-order bias-corrected (Δp, Δq, Δv) (Preintegration.h:196-215)."""
    dba = ba_i - pre.lin_ba
    dbg = bg_i - pre.lin_bg
    J = pre.jacobian
    dp = (pre.delta_p + _matvec(J[..., O_P:O_P+3, O_BA:O_BA+3], dba)
          + _matvec(J[..., O_P:O_P+3, O_BG:O_BG+3], dbg))
    dv = (pre.delta_v + _matvec(J[..., O_V:O_V+3, O_BA:O_BA+3], dba)
          + _matvec(J[..., O_V:O_V+3, O_BG:O_BG+3], dbg))
    dq = quat.normalize(quat.mul(
        pre.delta_q, quat.delta_q(_matvec(J[..., O_R:O_R+3, O_BG:O_BG+3], dbg))))
    return dp, dq, dv


def residual(pre: Preintegrated, p_i, q_i, v_i, ba_i, bg_i,
             p_j, q_j, v_j, ba_j, bg_j, gravity):
    """Raw 15-vector IMU residual (Preintegration.h:216-234)."""
    dp, dq, dv = bias_corrected_delta(pre, ba_i, bg_i)
    dt = pre.sum_dt[..., None]
    qi_inv = quat.conj(q_i)
    r_p = quat.rotate(qi_inv, 0.5 * gravity * dt * dt + p_j - p_i - v_i * dt) - dp
    r_q = 2.0 * quat.mul(quat.conj(dq), quat.mul(qi_inv, q_j))[..., 1:4]
    r_v = quat.rotate(qi_inv, gravity * dt + v_j - v_i) - dv
    return torch.cat([r_p, r_q, r_v, ba_j - ba_i, bg_j - bg_i], dim=-1)


def sqrt_info(pre: Preintegrated):
    """Whitening matrix inv(chol(covariance)) in f64 (ImuFactor.h:44-47)."""
    L = cholesky_or_nan(pre.covariance.to(F64))
    eye = torch.eye(STATE_DIM, dtype=F64, device=L.device).expand_as(L)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def whitened_residual(pre: Preintegrated, *state_ij, gravity):
    """sqrt_info(pre) · residual: the whitening computed at every call (the
    window's solve takes ``whitened_residual_cached``)."""
    return _matvec(sqrt_info(pre), residual(pre, *state_ij, gravity=gravity))


def whitened_residual_cached(S, pre: Preintegrated, *state_ij, gravity):
    """S · residual, with the whitening S = ``sqrt_info(pre)`` computed once
    per solve and not once per residual evaluation."""
    return _matvec(S, residual(pre, *state_ij, gravity=gravity))
