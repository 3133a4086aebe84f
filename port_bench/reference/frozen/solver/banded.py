"""Block-banded Gauss-Newton systems (port of ``glio_tpu/solver/banded.py``).

The batch stage's normal equations are block-banded: every factor couples
keyframes at most ``hw`` apart. ``band[t, o]`` holds the (D, D) block
H[t, t + o − hw]. Frozen for the benchmark's reference: the scatter-add
that assembles it and the exact f64 solve by block cyclic reduction, the
level-0 ``direct`` solver (the port's PCG solvers, band Cholesky and
selected inverse are not copied).

Determinism: ``scatter_add_blocks`` sums duplicate targets one occurrence
at a time in the order of the updates, as ``.at[].add`` does on the CPU, so
two runs on the card give the same band bit for bit (an atomic add would
not). A failed Cholesky gives NaN, as in JAX, through ``cholesky_ex``.
"""

from typing import NamedTuple

import numpy as np
import torch

from .linalg import cholesky_or_nan


# --- deterministic scatter-add --------------------------------------------------

def occurrence_groups(index) -> list:
    """Split the positions of ``index`` (N,) into groups in which every
    value occurs at most once: group g holds each value's (g+1)-th
    occurrence. Host numpy; returns a list of int64 position arrays."""
    index = np.asarray(index).reshape(-1)
    n = index.shape[0]
    if n == 0:
        return []
    order = np.argsort(index, kind="stable")
    sorted_index = index[order]
    run_start = np.r_[True, sorted_index[1:] != sorted_index[:-1]]
    first = np.maximum.accumulate(np.where(run_start, np.arange(n), 0))
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n) - first
    return [np.nonzero(rank == g)[0] for g in range(int(rank.max()) + 1)]


class ScatterPlan(NamedTuple):
    """Targets of a scatter-add, split into groups of distinct targets.

    ``index`` (N,) are the flat targets; ``groups`` are device tensors of
    positions into it, or None when all targets are distinct. Made once
    from host indices, so a scatter inside a solver loop does not wait on
    the device."""
    index: torch.Tensor
    groups: tuple


def scatter_plan(index, device) -> ScatterPlan:
    index = np.asarray(index, np.int64).reshape(-1)
    groups = occurrence_groups(index)
    dev = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
    return ScatterPlan(dev(index),
                       None if len(groups) <= 1 else tuple(dev(g) for g in groups))


def block_plan(rows, cols, hw: int, device) -> ScatterPlan:
    """Plan for ``scatter_add_blocks`` at (row, col) block coordinates
    (host int arrays, |col − row| ≤ hw)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    return scatter_plan(rows * (2 * hw + 1) + (cols - rows + hw), device)


def scatter_add_rows(x, values, plan: ScatterPlan):
    """x[plan.index[n]] += values[n] along the first axis, in place; a
    target that occurs several times gets its values added one at a time
    in their order. Returns x."""
    if plan.groups is None:
        return x.index_put_((plan.index,), x[plan.index] + values)
    for g in plan.groups:
        i = plan.index[g]
        x.index_put_((i,), x[i] + values[g])
    return x


# --- solvers ---------------------------------------------------------------------

def _chol_solve(L, X):
    Y = torch.linalg.solve_triangular(L, X, upper=False)
    return torch.linalg.solve_triangular(L.mT, Y, upper=True)


def _spd_solve_batched(B, X):
    """Solve B @ Y = X for a batch of SPD blocks (..., S, S); NaN where a
    block is not positive definite."""
    return _chol_solve(cholesky_or_nan(B), X)


def band_to_tridiag(band):
    """Block band (T, 2hw+1, D, D) → block-tridiagonal super-rows.

    Returns (A, B, C, N, S): B (N, S, S) diagonal super-blocks, A the
    sub-diagonal (A[0] = 0), C the super-diagonal (C[N-1] = 0), with
    S = hw·D and T padded to N·hw by decoupled identity rows.
    """
    T, Bw, D, _ = band.shape
    hw = (Bw - 1) // 2
    S = hw * D
    N = -(-T // hw)
    pad = N * hw - T
    if pad:
        tail = torch.zeros((pad, Bw, D, D), dtype=band.dtype, device=band.device)
        tail[:, hw] = torch.eye(D, dtype=band.dtype, device=band.device)
        band = torch.cat([band, tail])
    # Row t = I·hw + r couples to column t + (o − hw): column slot
    # c = r + o − hw of super-row I, or c − hw of super-row I+1. Columns
    # of super-row I−1 (c < 0) come from the previous C by symmetry.
    rows = band.reshape(N, hw, Bw, D, D)
    Bsup = torch.zeros((N, hw, D, hw, D), dtype=band.dtype, device=band.device)
    Csup = torch.zeros_like(Bsup)
    for r in range(hw):
        for o in range(Bw):
            c = r + o - hw
            if 0 <= c < hw:
                Bsup[:, r, :, c, :] = rows[:, r, o]
            elif hw <= c < 2 * hw:
                Csup[:, r, :, c - hw, :] = rows[:, r, o]
    Bsup = Bsup.reshape(N, S, S)
    Csup = Csup.reshape(N, S, S)
    Asup = torch.cat([torch.zeros_like(Csup[:1]), Csup[:-1].mT])
    return Asup, Bsup, Csup, N, S


def tridiag_cr_solve(A, Bm, C, r):
    """Block-tridiagonal SPD solve by cyclic reduction, several RHS.

    A, Bm, C: (N, S, S) sub/main/super-diagonal blocks (A[0] = C[N-1] = 0);
    r: (N, S, K). Each level factors all odd diagonal blocks at once and
    eliminates them (symmetric Schur complements stay SPD, no pivoting).
    The number of levels depends only on N. Returns x: (N, S, K).
    """
    S = Bm.shape[-1]
    K = r.shape[-1]
    dtype, dev = Bm.dtype, Bm.device
    zl = torch.zeros((1, S, S), dtype=dtype, device=dev)
    zv = torch.zeros((1, S, K), dtype=dtype, device=dev)
    levels = []
    while A.shape[0] > 2:
        n_before_pad = A.shape[0]
        if n_before_pad % 2 == 0:
            # Pad to an odd count with a decoupled identity row.
            A = torch.cat([A, zl])
            Bm = torch.cat([Bm, torch.eye(S, dtype=dtype, device=dev)[None]])
            C = torch.cat([C, zl])
            r = torch.cat([r, zv])
        odd_B = Bm[1::2]
        L = cholesky_or_nan(odd_B)
        BiA = _chol_solve(L, A[1::2])          # B_j⁻¹ A_j
        BiC = _chol_solve(L, C[1::2])          # B_j⁻¹ C_j
        Bir = _chol_solve(L, r[1::2])          # (n_odd, S, K)
        levels.append((n_before_pad, BiA, BiC, Bir))
        ev_A, ev_B, ev_C, ev_r = A[0::2], Bm[0::2], C[0::2], r[0::2]
        n_ev = ev_A.shape[0]
        # Even row k couples to odd rows k−1 (absent for k = 0) and k
        # (absent for the last even row).
        L_BiC = torch.cat([zl, BiC[:n_ev - 1]])
        L_BiA = torch.cat([zl, BiA[:n_ev - 1]])
        L_Bir = torch.cat([zv, Bir[:n_ev - 1]])

        def rpad(x, z):
            return x if x.shape[0] == n_ev else torch.cat([x, z[:n_ev - x.shape[0]]])

        R_BiA = rpad(BiA, zl)
        R_BiC = rpad(BiC, zl)
        R_Bir = rpad(Bir, zv)
        Bm = ev_B - ev_A @ L_BiC - ev_C @ R_BiA
        r = ev_r - ev_A @ L_Bir - ev_C @ R_Bir
        A = -(ev_A @ L_BiA)
        C = -(ev_C @ R_BiC)
        A[0] = 0.0
        C[-1] = 0.0

    # Base case: one or two super-rows, one dense SPD solve.
    if A.shape[0] == 1:
        x = _spd_solve_batched(Bm[0], r[0])[None]
    else:
        H2 = torch.cat([torch.cat([Bm[0], C[0]], 1),
                        torch.cat([A[1], Bm[1]], 1)], 0)
        x = _spd_solve_batched(H2, r.reshape(2 * S, K)).reshape(2, S, K)

    # Back-substitution through the levels in reverse.
    for n_before_pad, BiA, BiC, Bir in reversed(levels):
        n_odd = BiA.shape[0]
        x_odd = Bir - BiA @ x[:n_odd] - BiC @ x[1:n_odd + 1]
        n_prev = x.shape[0] + n_odd
        out = torch.empty((n_prev, S, K), dtype=dtype, device=dev)
        out[0::2] = x[:(n_prev + 1) // 2]
        out[1::2] = x_odd
        x = out[:n_before_pad]
    return x


def cyclic_reduction_solve(band, b):
    """Exact banded solve by block cyclic reduction (log-depth)."""
    T, Bw, D, _ = band.shape
    hw = (Bw - 1) // 2
    A, Bm, C, N, S = band_to_tridiag(band)
    bsup = torch.zeros((N * hw, D), dtype=band.dtype, device=band.device)
    bsup[:T] = b
    x = tridiag_cr_solve(A, Bm, C, bsup.reshape(N, S)[..., None])[..., 0]
    return x.reshape(-1, D)[:T]
