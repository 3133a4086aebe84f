"""Exact sharded banded solve: SPIKE-partitioned block cyclic reduction (port of
``glio_tpu/parallel/spike_cr.py``).

The band's super-rows (``solver.banded.band_to_tridiag``: S = hw·D, each
coupled only to its neighbours) are split over the ranks of a process group,
``n_loc ≥ 2`` to a rank, the last rank's tail padded with decoupled identity
rows (``partition``). Each rank

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

from typing import NamedTuple

import torch

from ..solver.banded import band_to_tridiag, tridiag_cr_solve
from . import Comm


class Part(NamedTuple):
    """One rank's share of a T-row band: super-rows [lo, hi) of the
    N = ⌈T / hw⌉, n_loc = max(2, ⌈N / n_ranks⌉) a rank, i.e. band rows
    [t0, t1). A rank past the last real super-row holds none (lo = hi = N,
    t0 = t1 = T)."""
    n_loc: int
    lo: int
    hi: int
    t0: int
    t1: int


def partition(T: int, hw: int, rank: int, n_ranks: int) -> Part:
    """The rows rank ``rank`` of ``n_ranks`` owns: the one partition of the
    sharded solve and of the rank-local assembly (``parallel.assembly``)."""
    N = -(-T // hw)
    n_loc = max(2, -(-N // n_ranks))
    lo, hi = min(rank * n_loc, N), min((rank + 1) * n_loc, N)
    return Part(n_loc, lo, hi, min(lo * hw, T), min(hi * hw, T))


def _local_rows(band, b, part: Part, T: int):
    """This rank's n_loc super-rows (A, B, C, r) from its own band rows
    ``band`` (t1 − t0, 2hw+1, D, D) and right-hand side ``b`` (t1 − t0, D).

    A[0], the coupling to the previous rank's last super-row, is read from
    the sub-diagonal blocks of the rank's first rows (the band is
    symmetric). Super-rows past the last real one, N − 1, are identity rows."""
    _, Bw, D, _ = band.shape
    hw = (Bw - 1) // 2
    S = hw * D
    dtype, dev = band.dtype, band.device
    A = torch.zeros((part.n_loc, S, S), dtype=dtype, device=dev)
    C = torch.zeros_like(A)
    Bm = torch.eye(S, dtype=dtype, device=dev).repeat(part.n_loc, 1, 1)
    r = torch.zeros((part.n_loc, S), dtype=dtype, device=dev)
    n = part.hi - part.lo
    if n:
        A_c, B_c, C_c, _, _ = band_to_tridiag(band)
        A[:n], Bm[:n], C[:n] = A_c, B_c, C_c
        r_c = torch.zeros((n * hw, D), dtype=dtype, device=dev)
        r_c[:part.t1 - part.t0] = b
        r[:n] = r_c.reshape(n, S)
        if part.lo:
            # Row lo·hw + i couples to column slot i + o of super-row lo − 1
            # through its offsets o < hw − i.
            A0 = torch.zeros((hw, D, hw, D), dtype=dtype, device=dev)
            for i in range(min(hw, part.t1 - part.t0)):
                for o in range(hw - i):
                    A0[i, :, i + o, :] = band[i, o]
            A[0] = A0.reshape(S, S)
        if part.t1 == T:
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
    system on every rank, → the exact (T, D) solution on every rank. Its
    entry ``solve.rows(band_rows, b_rows, T)`` takes only the rank's own rows
    [t0, t1) of ``partition(T, hw, rank, n_ranks)``, as the rank-local
    assembly makes them; ``solve`` slices those rows and calls it. Each rank
    eliminates only its own super-rows. ``solve.comm`` counts and times the
    collectives.
    """
    comm = Comm.of(group)

    def rows(band_rows, b_rows, T: int):
        part = partition(T, hw, comm.rank, comm.size)
        n = part.t1 - part.t0
        if band_rows.shape[0] != n or b_rows.shape[0] != n:
            raise ValueError(f"rank {comm.rank} owns rows [{part.t0}, {part.t1}) of T = {T}; "
                             f"got {band_rows.shape[0]} band and {b_rows.shape[0]} rhs rows")
        x_l = _partition_solve(*_local_rows(band_rows, b_rows, part, T), comm)
        return torch.cat(comm.all_gather(x_l)).reshape(-1, band_rows.shape[-1])[:T]

    def solve(band, b):
        T = band.shape[0]
        part = partition(T, hw, comm.rank, comm.size)
        return rows(band[part.t0:part.t1], b[part.t0:part.t1], T)

    solve.rows = rows
    solve.comm = comm
    return solve
