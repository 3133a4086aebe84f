"""Block-Jacobi PCG time-sharded over ranks (port of ``glio_tpu/parallel/banded_pcg.py``).

The ranks of a process group form a ``dp × sp`` layout, rank r = d·sp + s:
``dp`` rows solve independent problems (episodes), the ``sp`` ranks of a row
share the time axis of one problem. The banded matvec takes ``hw`` halo rows
from each time neighbour (zero at the first and last shard: the system's
zero boundary), the CG dot products are summed over the ``sp`` ranks of the
row only, and the block-Jacobi preconditioner stays on the rank.
"""

import torch
import torch.distributed as dist

from ..solver.banded import _chol_solve
from ..solver.linalg import cholesky_or_nan
from . import Comm


def _halo_matvec(band_l, x_l, hw: int, comm: Comm):
    """Local banded matvec with the halos of the time neighbours.

    band_l: (nb, Tl, 2hw+1, D, D) local block rows; x_l: (nb, Tl, D), Tl ≥ hw.
    The halos go by one all-gather of every shard's first and last hw rows
    over the ``sp`` ranks.
    """
    n, s = comm.size, comm.rank
    zero = torch.zeros_like(x_l[:, :hw])
    if n > 1:
        edges = comm.all_gather(torch.cat([x_l[:, :hw], x_l[:, -hw:]], dim=1))
        left = edges[s - 1][:, hw:] if s > 0 else zero
        right = edges[s + 1][:, :hw] if s < n - 1 else zero
    else:
        left = right = zero
    x_ext = torch.cat([left, x_l, right], dim=1)
    Tl = x_l.shape[1]
    y = torch.zeros_like(x_l)
    for o in range(band_l.shape[2]):
        y = y + torch.einsum("ntij,ntj->nti", band_l[:, :, o], x_ext[:, o:o + Tl])
    return y


def _pcg_body(band_l, b_l, hw: int, iters: int, comm: Comm):
    D = b_l.shape[-1]
    eye = torch.eye(D, dtype=band_l.dtype, device=band_l.device)
    L = cholesky_or_nan(band_l[:, :, hw] + 1e-12 * eye)

    def precond(r):
        return _chol_solve(L, r[..., None])[..., 0]

    def dot(a, c):
        local = torch.sum(a * c, dim=(1, 2))
        return comm.all_reduce_sum(local) if comm.size > 1 else local

    def mv(x):
        return _halo_matvec(band_l, x, hw, comm)

    x = torch.zeros_like(b_l)
    r = b_l - mv(x)
    p = precond(r)
    rz = dot(r, p)
    zero = torch.zeros_like(rz)
    for _ in range(iters):
        Ap = mv(p)
        pAp = dot(p, Ap)
        alpha = torch.where(pAp > 0, rz / torch.clamp(pAp, min=1e-300), zero)
        x = x + alpha[:, None, None] * p
        r = r - alpha[:, None, None] * Ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = torch.where(rz > 0, rz_new / torch.clamp(rz, min=1e-300), zero)
        p = z + beta[:, None, None] * p
        rz = rz_new
    return x, torch.sqrt(torch.clamp(dot(r, r), min=0.0))


def make_sharded_pcg(group, hw: int, iters: int = 60, dp: int = 1, sp: int = None):
    """Block-Jacobi PCG over the ranks of ``group`` (None: the default group)
    laid out ``dp × sp`` (sp defaults to the group's size over dp).

    Returns solve(band, b): band (NB, T, 2hw+1, D, D) and b (NB, T, D), the
    whole problems on every rank, NB split over dp and T over sp → (x (NB, T,
    D), |r| (NB,)) on every rank. Every rank must call this function: it
    makes each row's ``sp`` sub-group. ``solve.comm`` / ``solve.sp_comm``
    count and time the collectives of the whole group / of the row.
    """
    world = Comm(group)
    sp = world.size // dp if sp is None else sp
    if dp * sp != world.size:
        raise ValueError(f"a dp={dp} x sp={sp} layout needs {dp * sp} ranks, the group "
                         f"has {world.size}")
    ranks = dist.get_process_group_ranks(group) if group is not None \
        else list(range(world.size))
    d_row = world.rank // sp
    sp_group = None
    for d in range(dp):                  # every rank makes every row's group
        g = dist.new_group(ranks[d * sp:(d + 1) * sp])
        if d == d_row:
            sp_group = g
    sp_comm = Comm(sp_group)

    def solve(band, b):
        nb, T = b.shape[0], b.shape[1]
        if T % sp != 0 or nb % dp != 0:
            raise ValueError(
                f"(NB={nb}, T={T}) not divisible by the layout (dp={dp}, sp={sp}); pad T "
                f"to a multiple of sp with identity diagonal blocks and zero rhs (and NB "
                f"to a multiple of dp) before calling.")
        nbl, Tl = nb // dp, T // sp
        if Tl < hw:
            raise ValueError(f"{Tl} rows a shard, fewer than the band half-width {hw}: "
                             f"the halo would reach past the neighbouring shard")
        d, s = world.rank // sp, world.rank % sp
        rows = slice(d * nbl, (d + 1) * nbl)
        cols = slice(s * Tl, (s + 1) * Tl)
        x_l, res_l = _pcg_body(band[rows, cols], b[rows, cols], hw, iters, sp_comm)
        xs = world.all_gather(x_l)
        res = world.all_gather(res_l)
        x = torch.cat([torch.cat(xs[d * sp:(d + 1) * sp], dim=1) for d in range(dp)])
        return x, torch.cat([res[d * sp] for d in range(dp)])

    solve.comm = world
    solve.sp_comm = sp_comm
    return solve
