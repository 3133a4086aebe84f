"""The rank-local assembly of ``optimize_batch_sharded``, every rank in one process.

Each rank's slice of the problem (``parallel.assembly.RankShare``) is built
with its ``(rank, n_ranks)`` and held against the single-device
``_assemble_core_impl`` on the whole problem: its owned band and gradient
rows, its IRLS weights, the factors it owns (each factor exactly once over
the ranks) and its partial costs, summed in rank order. The drive is
``testing.SHARDED_DRIVE``'s at T = 96 and two cuts of it; the solve's own
half of the partition (``spike_cr._local_rows`` from the owned rows) is
held against ``band_to_tridiag`` of the whole band. No process group: the
four-rank run against JAX is ``tests/test_torch_parallel.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from glio_tpu_torch import testing
from glio_tpu_torch.config import GlioConfig
from glio_tpu_torch.data.simulator import simulate_gnss_epochs
from glio_tpu_torch.models import batch as tbatch
from glio_tpu_torch.parallel import assembly, spike_cr
from glio_tpu_torch.solver import banded as tbanded
from test_parallel import _random_banded

TOL = 1e-12

# (T, n_ranks): the drive at 2 and 4 ranks (at 4 the last rank holds 2 of its
# 4 super-rows, the last one cut); T = 75, the last rank partly filled; T = 33,
# 5 super-rows of 7 keyframes over 4 ranks, the last rank identity padding only.
CASES = ((96, 2), (96, 4), (75, 4), (33, 4))


def _cfg(doppler):
    base = GlioConfig()
    return base.replace(estimator=dataclasses.replace(base.estimator, doppler_in_batch=doppler))


@pytest.fixture(scope="module")
def problem():
    """problem(T, doppler): the drive cut to T keyframes, its problem, and a
    point (p, q) off the odometry at which to assemble; made once each."""
    made = {}

    def get(T, doppler):
        if (T, doppler) not in made:
            sc = dict(testing.SHARDED_DRIVE, n_keyframes=T)
            kf_time, _, q_true, gnss, p_odo = testing.sharded_drive(sc, simulate_gnss_epochs)
            cfg = _cfg(doppler)
            prob = tbatch.build_problem(cfg, p_odo, q_true, kf_time, gnss, testing.ANCHOR_ECEF,
                                        0.0, testing.STATION_ECEF, device="cpu")
            rng = np.random.default_rng(T)
            p = prob.p_odo + torch.as_tensor(rng.normal(scale=0.3, size=(T, 3)))
            q = tbatch.quat.normalize(prob.q_odo + torch.as_tensor(
                rng.normal(scale=0.02, size=(T, 4))))
            made[T, doppler] = (cfg, sc, prob, p, q)
        return made[T, doppler]

    return get


def _rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("doppler", [False, True], ids=["dd", "doppler"])
@pytest.mark.parametrize("T,n_ranks", CASES, ids=[f"T{T}_ranks{n}" for T, n in CASES])
def test_owned_rows_weights_and_costs_equal_the_whole_problems(problem, T, n_ranks, doppler):
    cfg, sc, prob, p, q = problem(T, doppler)
    hw = cfg.estimator.search_range + 1
    robust = testing.robust_opts(tbatch, sc)
    th = sc["thresholds"][-1]
    band, grad, cost, w_rel, w_dd = tbatch._assemble_core_impl(
        p, q, prob, th, hw, robust=robust, use_doppler=doppler)
    trial = tbatch._total_cost(p, q, prob, th, w_rel, w_dd, doppler)
    plain = tbatch._total_cost(p, q, prob, th, use_doppler=doppler)
    H = assembly.halo(prob)
    n_rel = torch.zeros(prob.rel_valid.shape[0], dtype=torch.int64)
    n_ep = torch.zeros(prob.ep_left.shape[0], dtype=torch.int64)
    parts = []
    rows = []
    for rank in range(n_ranks):
        share = assembly.RankShare(prob, hw, rank, n_ranks, doppler, "cpu")
        part = share.part
        assert part == spike_cr.partition(T, hw, rank, n_ranks)
        b_l, g_l, c_l, wr_l, wd_l = share.assemble(p, q, th, robust)
        assert b_l.shape[0] == g_l.shape[0] == part.t1 - part.t0
        rows.append((part.t0, part.t1))
        if share.prob is None:
            assert part.t0 == part.t1 == T and float(c_l) == 0.0
            parts.append((c_l, share.cost(p, q, th), share.cost(p, q, th)))
            continue
        T_l = share.prob.p_odo.shape[0]
        assert T_l <= part.n_loc * hw + 2 * H
        assert share.prob.sat_pos.shape[0] < prob.sat_pos.shape[0] or n_ranks == 1
        # The owned rows are the whole band's, bit for bit on this drive.
        assert _rel_err(b_l, band[part.t0:part.t1]) <= TOL
        assert _rel_err(g_l, grad[part.t0:part.t1]) <= TOL
        assert torch.equal(b_l, band[part.t0:part.t1])
        assert torch.equal(g_l, grad[part.t0:part.t1])
        # The weights of every factor the rank owns are the whole problem's.
        own_rel = share.own_rel.bool()
        a = share.start
        assert torch.equal(wr_l[own_rel], w_rel[a:a + T_l][own_rel])
        own_ep = share.own_ep.bool()
        ep = torch.as_tensor(share.epochs)
        assert torch.equal(wd_l[own_ep], w_dd[ep][own_ep])
        n_rel[a:a + T_l] += own_rel.long()
        n_ep[ep] += own_ep.long()
        parts.append((c_l, share.cost(p, q, th, wr_l, wd_l), share.cost(p, q, th)))
    # The ranks' rows tile [0, T); each factor is owned exactly once.
    assert rows[0][0] == 0 and rows[-1][1] == T
    assert all(rows[k][1] == rows[k + 1][0] for k in range(n_ranks - 1))
    assert torch.all(n_rel == 1) and torch.all(n_ep == 1)
    for k, want in enumerate((cost, trial, plain)):
        total = parts[0][k]
        for c in parts[1:]:
            total = total + c[k]
        assert abs(float(total) - float(want)) <= TOL * abs(float(want))


def test_the_last_pairs_of_a_slice_are_masked(problem):
    cfg, sc, prob, p, q = problem(96, False)
    hw = cfg.estimator.search_range + 1
    share = assembly.RankShare(prob, hw, 1, 4, False, "cpu")
    T_l, R = share.prob.rel_valid.shape
    a = share.start
    for r in range(R):
        # Pairs (i, i + r + 1) inside the slice keep the whole problem's flag.
        assert torch.equal(share.prob.rel_valid[:T_l - r - 1, r],
                           prob.rel_valid[a:a + T_l - r - 1, r])
        assert not share.prob.rel_valid[T_l - r - 1:, r].any()


@pytest.mark.parametrize("T,hw,n_ranks", [(257, 3, 4), (20, 2, 4), (10, 2, 4), (61, 7, 3)])
def test_solve_rows_from_owned_rows_equal_band_to_tridiag(T, hw, n_ranks):
    band, b = (torch.as_tensor(np.asarray(x)[0]) for x in _random_banded(T, 4, hw, seed=T))
    A, Bm, C, N, S = tbanded.band_to_tridiag(band)
    r = torch.zeros((N * hw, 4), dtype=band.dtype)
    r[:T] = b
    r = r.reshape(N, S)
    for rank in range(n_ranks):
        part = spike_cr.partition(T, hw, rank, n_ranks)
        A_l, B_l, C_l, r_l = spike_cr._local_rows(band[part.t0:part.t1], b[part.t0:part.t1],
                                                  part, T)
        n = part.hi - part.lo
        assert A_l.shape[0] == part.n_loc
        # A symmetric band: the sub-diagonal blocks are the transposes, bit for bit.
        assert torch.equal(A_l[:n], A[part.lo:part.hi])
        assert torch.equal(B_l[:n], Bm[part.lo:part.hi])
        assert torch.equal(C_l[:n], C[part.lo:part.hi])
        assert torch.equal(r_l[:n], r[part.lo:part.hi])
        eye = torch.eye(S, dtype=band.dtype)
        assert torch.equal(B_l[n:], eye.expand(part.n_loc - n, S, S))
        assert not A_l[n:].any() and not C_l[n:].any() and not r_l[n:].any()
