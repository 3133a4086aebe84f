"""Block-banded Gauss-Newton systems (port of ``glio_tpu/solver/banded.py``).

The batch stage's normal equations are block-banded: every factor couples
keyframes at most ``hw`` apart. ``band[t, o]`` holds the (D, D) block
H[t, t + o − hw]. This module has the band storage and its matvec, the
scatter-add that assembles it, block-Jacobi PCG, the exact solve by block
cyclic reduction and the selected inverse of the diagonal blocks.

The solves are f64 on the card: the JAX package's TPU workarounds
(``cyclic_reduction_solve_mixed``, ``f32_matmul_precision``) exist because
TPU f64 is emulated and have no counterpart. The sequential
``block_cholesky`` with ``direct_solve`` and ``woodbury_solve`` (banded
plus a few dense rows: loop closure) are here, and ``pcg_chol_solve``, the
``chol_pcg`` solver a user selects: CG on the f64 band, preconditioned by
an equilibrated f32 Cholesky factor (``_equilibrate``,
``f32_chol_precond``, ``f32_chol_apply``; on the card the CUDA kernels of
``ops/band_chol.py``), as in the JAX package.

Determinism: ``scatter_add_blocks`` sums duplicate targets one occurrence
at a time in the order of the updates, as ``.at[].add`` does on the CPU, so
two runs on the card give the same band bit for bit (an atomic add would
not). A failed Cholesky gives NaN, as in JAX, through ``cholesky_ex``.
"""

from typing import NamedTuple

import numpy as np
import torch

from .linalg import cholesky_or_nan, spd_solve


class BandedSystem(NamedTuple):
    """H in block-band storage: band[t, o] = H[t, t + o − hw] (zero out of
    range), so o = hw is the main diagonal; b is the right-hand side."""
    band: torch.Tensor   # (T, 2*hw+1, D, D)
    b: torch.Tensor      # (T, D)

    @property
    def hw(self):
        return (self.band.shape[1] - 1) // 2


def band_matvec(band, x):
    """y[t] = Σ_o band[t, o] @ x[t + o − hw] (zero outside range)."""
    T, B = band.shape[:2]
    hw = (B - 1) // 2
    idx = torch.arange(T, device=x.device)
    y = torch.zeros_like(x)
    for o in range(B):
        shift = o - hw
        xs = torch.roll(x, -shift, dims=0)
        ok = (idx + shift >= 0) & (idx + shift < T)
        xs = torch.where(ok[:, None], xs, torch.zeros_like(xs))
        y = y + torch.einsum("tij,tj->ti", band[:, o], xs)
    return y


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


def scatter_add_blocks(band, rows, cols, blocks, hw, plan: ScatterPlan = None):
    """band[rows, cols − rows + hw] += blocks, in place (returns band).

    rows, cols: (N,) block coordinates with |col − row| ≤ hw, host arrays
    or tensors; blocks: (N, D, D). Pass ``plan`` (``block_plan`` of the
    same rows and cols) to scatter without reading indices to the host.
    """
    if plan is None:
        as_np = lambda a: a.cpu().numpy() if isinstance(a, torch.Tensor) else a
        plan = block_plan(as_np(rows), as_np(cols), hw, band.device)
    T, B, D, _ = band.shape
    scatter_add_rows(band.view(T * B, D, D), blocks, plan)
    return band


# --- solvers ---------------------------------------------------------------------

def _chol_solve(L, X):
    Y = torch.linalg.solve_triangular(L, X, upper=False)
    return torch.linalg.solve_triangular(L.mT, Y, upper=True)


def pcg_solve(band, b, iters: int = 100, tol: float = 1e-10):
    """Block-Jacobi preconditioned CG on the banded SPD system, a fixed
    number of iterations; returns (x, |r|). ``tol`` is accepted for the
    JAX signature and, as there, not used."""
    T, B, D, _ = band.shape
    hw = (B - 1) // 2
    eye = torch.eye(D, dtype=band.dtype, device=band.device)
    L = cholesky_or_nan(band[:, hw] + 1e-12 * eye)

    def precond(r):
        return _chol_solve(L, r[..., None])[..., 0]

    x = torch.zeros_like(b)
    r = b - band_matvec(band, x)
    p = precond(r)
    rz = torch.sum(r * p)
    for _ in range(iters):
        Ap = band_matvec(band, p)
        pAp = torch.sum(p * Ap)
        alpha = torch.where(pAp > 0, rz / torch.clamp(pAp, min=1e-300),
                            torch.zeros_like(pAp))
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = torch.where(rz > 0, rz_new / torch.clamp(rz, min=1e-300),
                           torch.zeros_like(rz))
        p = z + beta * p
        rz = rz_new
    return x, torch.sqrt(torch.clamp(torch.sum(r * r), min=0.0))


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


def block_cholesky(band, jitter: float = 0.0):
    """Lower block-banded Cholesky factor of a block-banded SPD matrix.

    band: (T, 2hw+1, D, D). Returns Lb (T, hw+1, D, D) with
    Lb[t, m] = L[t][t − m] (m = 0 the diagonal). One block row after the
    other, as the JAX package's scan: a sequence of T small steps. As there,
    a column whose diagonal block sums to 0 in absolute value, or to NaN (a
    block row whose Cholesky broke down), is set to zero in the rows below,
    so a breakdown stays in its own block row.
    """
    T, Bw, D, _ = band.shape
    hw = (Bw - 1) // 2
    jit = jitter * torch.eye(D, dtype=band.dtype, device=band.device)
    zero = torch.zeros((D, D), dtype=band.dtype, device=band.device)
    rows, ok = [], []
    for t in range(T):
        new = [zero] * (hw + 1)
        # Columns left to right: j = t − m for m = hw..1, then the diagonal.
        for m in range(hw, 0, -1):
            j = t - m
            if j < 0:
                continue
            # S = A[t][j] − Σ L[t][k] L[j][k]ᵀ over k = j − 1..j − (hw − m).
            S = band[t, hw - m]
            for k_off in range(1, hw - m + 1):
                S = torch.addmm(S, new[m + k_off], rows[j][k_off].mT, alpha=-1.0)
            # L[t][j] = S L[j][j]⁻ᵀ.
            val = torch.linalg.solve_triangular(rows[j][0], S.mT, upper=False).mT
            new[m] = torch.where(ok[j], val, zero)
        S = band[t, hw]
        for m in range(1, hw + 1):
            S = torch.addmm(S, new[m], new[m].mT, alpha=-1.0)
        new[0] = cholesky_or_nan(S + jit)
        ok.append(new[0].abs().sum() > 0)
        rows.append(new)
    return torch.stack([torch.stack(r) for r in rows])


def block_cholesky_solve(Lb, b):
    """Solve H x = b with ``block_cholesky``'s factor; b is (T, D) or, for
    several right-hand sides at once, (T, D, K)."""
    T, HW1, D, _ = Lb.shape
    hw = HW1 - 1
    vector = b.dim() == 2
    rhs = b[..., None] if vector else b
    # Forward: L y = b.
    y = []
    for t in range(T):
        s = rhs[t]
        for m in range(1, min(hw, t) + 1):
            s = s - Lb[t, m] @ y[t - m]
        y.append(torch.linalg.solve_triangular(Lb[t, 0], s, upper=False))
    # Backward: Lᵀ x = y, with L[t+m][t]ᵀ = Lb[t+m, m]ᵀ.
    x = [None] * T
    for t in range(T - 1, -1, -1):
        s = y[t]
        for m in range(1, min(hw, T - 1 - t) + 1):
            s = s - Lb[t + m, m].mT @ x[t + m]
        x[t] = torch.linalg.solve_triangular(Lb[t, 0].mT, s, upper=True)
    x = torch.stack(x)
    return x[..., 0] if vector else x


def direct_solve(band, b, jitter: float = 1e-12):
    """Exact banded solve: block Cholesky and two substitution sweeps."""
    return block_cholesky_solve(block_cholesky(band, jitter=jitter), b)


def woodbury_solve(band, b, J_extra, r_extra, jitter: float = 1e-12):
    """Solve (H_band + J_extraᵀ J_extra) x = b − J_extraᵀ r_extra.

    Loop-closure rows break the band; with few of them the system is
    banded plus low rank, so with S = H_band⁻¹ (block Cholesky) and
    b' = b − Jᵀr, x = S b' − S Jᵀ (I + J S Jᵀ)⁻¹ J S b'. J_extra is
    (L, T, D): the extra rows' Jacobian, dense over the keyframes.
    """
    Lb = block_cholesky(band, jitter=jitter)
    rhs = b - torch.einsum("ltd,l->td", J_extra, r_extra)
    # S b' and S Jᵀ in one pair of sweeps: L + 1 right-hand sides.
    cols = torch.cat([rhs[..., None], J_extra.permute(1, 2, 0)], dim=-1)
    sol = block_cholesky_solve(Lb, cols)
    Sb, SJt = sol[..., 0], sol[..., 1:].permute(2, 0, 1)
    L = J_extra.shape[0]
    core = torch.eye(L, dtype=band.dtype, device=band.device) + torch.einsum(
        "ltd,mtd->lm", J_extra, SJt)
    w = spd_solve(core, torch.einsum("ltd,td->l", J_extra, Sb))
    return Sb - torch.einsum("ltd,l->td", SJt, w)


def selected_inverse_diag(band):
    """The (D, D) diagonal blocks of H⁻¹ for a banded SPD H: the marginal
    covariances of a Gauss-Newton system at its solution.

    Block-tridiagonal selected inversion over the hw·D super-rows:
    U_1 = B_1, U_i = B_i − A_i U_{i−1}⁻¹ A_iᵀ (forward);
    V_N = B_N, V_i = B_i − C_i V_{i+1}⁻¹ C_iᵀ (backward);
    Σ_ii = (U_i + V_i − B_i)⁻¹. Two sequential sweeps of N − 1 steps.
    """
    T, Bw, D, _ = band.shape
    hw = (Bw - 1) // 2
    A, Bm, C, N, S = band_to_tridiag(band)
    U = [Bm[0]]
    for i in range(1, N):
        U.append(Bm[i] - A[i] @ _spd_solve_batched(U[-1], A[i].mT))
    V = [Bm[-1]]
    for i in range(N - 2, -1, -1):
        V.append(Bm[i] - C[i] @ _spd_solve_batched(V[-1], C[i].mT))
    M = torch.stack(U) + torch.stack(V[::-1]) - Bm
    eye = torch.eye(S, dtype=band.dtype, device=band.device).expand(N, S, S)
    Sig = _spd_solve_batched(M, eye).reshape(N, hw, D, hw, D)
    diag = torch.stack([Sig[:, r, :, r, :] for r in range(hw)], dim=1)
    return diag.reshape(N * hw, D, D)[:T]


# --- CG preconditioned by an f32 banded Cholesky factor (``chol_pcg``) ----------

def _equilibrate(band):
    """Symmetric Jacobi scaling: (band_s, s) with band_s[t, o, i, j] =
    band[t, o, i, j]·s[t, i]·s[t + o − hw, j], s = diag^(−1/2), which takes
    the 1e8 spread between the attitude and translation blocks out of the
    f32 factor."""
    T, Bw, D, _ = band.shape
    hw = (Bw - 1) // 2
    diag = torch.diagonal(band[:, hw], dim1=-2, dim2=-1)
    s = 1.0 / torch.sqrt(torch.clamp(diag, min=1e-12))
    idx = torch.arange(T, device=band.device)
    cols = []
    for o in range(Bw):
        shift = o - hw
        ok = (idx + shift >= 0) & (idx + shift < T)
        cols.append(torch.where(ok[:, None], torch.roll(s, -shift, dims=0), torch.zeros_like(s)))
    S_col = torch.stack(cols, dim=1)
    return band * s[:, None, :, None] * S_col[:, :, None, :], s


class F32CholPrecond(NamedTuple):
    """M = L Lᵀ ≈ the equilibrated band, with its equilibration: M⁻¹r is
    ``block_cholesky_solve(Lb, r·s)·s``, in f32."""
    s: torch.Tensor       # (T, D) f64 equilibration
    Lb: torch.Tensor      # (T, hw + 1, D, D) f32, as ``block_cholesky``'s


def f32_chol_precond(band, jitter: float = 3e-4) -> F32CholPrecond:
    """The JAX package's ``_f32_chol_precond``: the f32 ``block_cholesky`` of
    the equilibrated band (+ jitter·I; on the card the kernel
    ``ops.band_chol.band_cholesky``), block row by block row as there (a
    factor taken one hw·D super-row at a time rounds otherwise, and on a
    long stiff chain lands about 4x further from the exact factor). A block
    row whose f32 Schur complement broke down (``block_cholesky`` keeps it
    to that row) is replaced by the identity, so M stays SPD."""
    from ..ops.band_chol import band_cholesky   # the kernel's wrapper imports this module
    band_s, s = _equilibrate(band)
    Lb = band_cholesky(band_s.to(torch.float32).contiguous(), jitter=jitter)
    T, HW1, D, _ = Lb.shape
    eye_row = torch.zeros_like(Lb[0])
    eye_row[0] = torch.eye(D, dtype=Lb.dtype, device=Lb.device)
    bad = ~torch.isfinite(Lb.reshape(T, -1)).all(dim=1)
    return F32CholPrecond(s, torch.where(bad[:, None, None, None], eye_row, Lb))


def f32_chol_apply(M: F32CholPrecond, r):
    """M⁻¹ r for r (T, D) f64: the two substitution sweeps of
    ``block_cholesky_solve`` in f32 (on the card the kernel
    ``ops.band_chol.band_cholesky_solve``), as ``_f32_chol_precond``'s
    apply; returns f64."""
    from ..ops.band_chol import band_cholesky_solve
    z = band_cholesky_solve(M.Lb, (r * M.s).to(torch.float32).contiguous())
    return z.to(r.dtype) * M.s


def pcg_chol_solve(band, b, iters: int = 14, jitter: float = 3e-4):
    """CG on the exact f64 band, preconditioned by the equilibrated f32
    banded Cholesky factor (``f32_chol_precond``), a fixed ``iters``
    iterations (the JAX package's ``pcg_chol_solve``: a pure f32 factor with
    stationary refinement diverges on long stiff chains, Krylov iteration
    tolerates the imperfect factor). Returns x (T, D)."""
    M = f32_chol_precond(band, jitter)
    x = torch.zeros_like(b)
    r = b - band_matvec(band, x)
    z = f32_chol_apply(M, r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(iters):
        Ap = band_matvec(band, p)
        pAp = torch.sum(p * Ap)
        alpha = torch.where(pAp > 0, rz / torch.clamp(pAp, min=1e-300), torch.zeros_like(pAp))
        x = x + alpha * p
        r = r - alpha * Ap
        z = f32_chol_apply(M, r)
        rz_new = torch.sum(r * z)
        beta = torch.where(rz > 0, rz_new / torch.clamp(rz, min=1e-300), torch.zeros_like(rz))
        p = z + beta * p
        rz = rz_new
    return x
