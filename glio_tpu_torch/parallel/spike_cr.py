"""Exact sharded banded solve: SPIKE-partitioned block cyclic reduction (port of
``glio_tpu/parallel/spike_cr.py``).

The band's super-rows (``solver.banded.band_to_tridiag``: S = hw·D, each
coupled only to its neighbours) are split over the ranks of a process group,
``n_loc ≥ 2`` to a rank, the last rank's tail padded with decoupled identity
rows. Each rank

1. Schur-eliminates its interior super-rows against its two boundary rows
   with one multi-RHS ``tridiag_cr_solve`` (2S + 1 columns), without any
   traffic;
2. all-gathers the reduced system of its two boundary rows, three (2, S, S)
   block pairs and a (2, S) right-hand side, in one collective;
3. solves the reduced tridiagonal system over the 2·n_ranks interface rows,
   redundantly on every rank;
4. back-substitutes its interior, and all-gathers the solution so that every
   rank returns the whole (T, D) vector, as the JAX function's global output.

Every step is an exact symmetric Schur complement, so the result equals the
single-device ``cyclic_reduction_solve`` to round-off.
"""

import torch

from ..solver.banded import band_to_tridiag, tridiag_cr_solve
from . import Comm


def _local_rows(band, b, hw: int, rank: int, n_dev: int):
    """This rank's super-rows (A, B, C, r), n_loc = max(2, ⌈N / n_dev⌉) of them.

    Only the band rows of the rank's super-rows, and of the one before (its
    super-diagonal block is this rank's first sub-diagonal block), are
    converted. Super-rows past the last real one, N − 1, are identity rows."""
    T, Bw, D, _ = band.shape
    S = hw * D
    N = -(-T // hw)
    n_loc = max(2, -(-N // n_dev))
    lo, hi = rank * n_loc, min((rank + 1) * n_loc, N)
    dtype, dev = band.dtype, band.device
    A = torch.zeros((n_loc, S, S), dtype=dtype, device=dev)
    C = torch.zeros_like(A)
    Bm = torch.eye(S, dtype=dtype, device=dev).repeat(n_loc, 1, 1)
    r = torch.zeros((n_loc, S), dtype=dtype, device=dev)
    if hi > lo:
        s0 = max(lo - 1, 0)
        t0, t1 = s0 * hw, min(hi * hw, T)
        A_c, B_c, C_c, n_c, _ = band_to_tridiag(band[t0:t1])
        r_c = torch.zeros((n_c * hw, D), dtype=dtype, device=dev)
        r_c[:t1 - t0] = b[t0:t1]
        k = lo - s0                      # the rank's first super-row in the chunk
        n = hi - lo
        A[:n], Bm[:n], C[:n] = A_c[k:], B_c[k:], C_c[k:]
        r[:n] = r_c.reshape(n_c, S)[k:]
        if hi == N:
            C[n - 1] = 0.0               # the last real row couples to nothing
    return A, Bm, C, r


def _partition_solve(A_l, B_l, C_l, r_l, comm: Comm):
    """SPIKE elimination of this rank's rows, the reduced solve over every
    rank's boundary rows and the back-substitution; returns x_l (n_loc, S)."""
    n_loc, S, _ = B_l.shape
    dtype, dev = B_l.dtype, B_l.device
    Bt, Bb = B_l[0], B_l[-1]
    At, Cb = A_l[0], C_l[-1]             # couplings to the neighbouring ranks
    Ct, Ab = C_l[0], A_l[-1]             # couplings into the local interior
    if n_loc > 2:
        A_I = A_l[1:-1].clone()
        C_I = C_l[1:-1].clone()
        A_I[0] = 0.0
        C_I[-1] = 0.0
        n_int = n_loc - 2
        # T_I⁻¹ [columns of x_top | columns of x_bottom | r_I].
        rhs = torch.zeros((n_int, S, 2 * S + 1), dtype=dtype, device=dev)
        rhs[0, :, :S] = A_l[1]
        rhs[-1, :, S:2 * S] = C_l[-2]
        rhs[:, :, 2 * S] = r_l[1:-1]
        sol = tridiag_cr_solve(A_I, B_l[1:-1], C_I, rhs)
        Yt, Yb, g = sol[..., :S], sol[..., S:2 * S], sol[..., 2 * S]
        S_tt = Bt - Ct @ Yt[0]
        S_tb = -Ct @ Yb[0]
        S_bt = -Ab @ Yt[-1]
        S_bb = Bb - Ab @ Yb[-1]
        rt = r_l[0] - Ct @ g[0]
        rb = r_l[-1] - Ab @ g[-1]
    else:
        S_tt, S_tb, S_bt, S_bb = Bt, Ct, Ab, Bb
        rt, rb = r_l[0], r_l[-1]

    # Interface rows in global order (t_0, b_0, t_1, b_1, ...): t_j couples
    # left to b_{j-1} by At_j, b_j right to t_{j+1} by Cb_j.
    packed = torch.cat([torch.stack([At, S_bt]).reshape(-1),
                        torch.stack([S_tt, S_bb]).reshape(-1),
                        torch.stack([S_tb, Cb]).reshape(-1),
                        torch.stack([rt, rb]).reshape(-1)])
    parts = comm.all_gather(packed)
    n2 = 2 * comm.size
    g_all = torch.stack(parts)
    m = 2 * S * S
    gA = g_all[:, :m].reshape(n2, S, S).clone()
    gB = g_all[:, m:2 * m].reshape(n2, S, S)
    gC = g_all[:, 2 * m:3 * m].reshape(n2, S, S).clone()
    gr = g_all[:, 3 * m:].reshape(n2, S)
    gA[0] = 0.0
    gC[-1] = 0.0
    xr = tridiag_cr_solve(gA, gB, gC, gr[..., None])[..., 0]
    x_t, x_b = xr[2 * comm.rank], xr[2 * comm.rank + 1]
    if n_loc > 2:
        x_int = (g - torch.einsum("nij,j->ni", Yt, x_t)
                 - torch.einsum("nij,j->ni", Yb, x_b))
        return torch.cat([x_t[None], x_int, x_b[None]])
    return torch.stack([x_t, x_b])


def make_sharded_cr_solve(group, hw: int):
    """The exact sharded banded solve over the ranks of ``group`` (a process
    group, None for the default group, or a ``Comm``).

    Returns solve(band, b): band (T, 2hw+1, D, D) and b (T, D), the whole
    system on every rank, → the exact (T, D) solution on every rank. Each
    rank eliminates only its own super-rows. ``solve.comm`` counts and
    times the collectives.
    """
    comm = Comm.of(group)

    def solve(band, b):
        T, _, D, _ = band.shape
        A, Bm, C, r = _local_rows(band, b, hw, comm.rank, comm.size)
        x_l = _partition_solve(A, Bm, C, r, comm)
        return torch.cat(comm.all_gather(x_l)).reshape(-1, D)[:T]

    solve.comm = comm
    return solve
