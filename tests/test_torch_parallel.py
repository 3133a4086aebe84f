"""Port parity: the multi-device batch solve, four gloo ranks against JAX on four devices.

The port's ranks (``glio_tpu_torch.parallel.launch.run_ranks``, gloo on the
CPU, a ``file://`` rendezvous) run every case at once in one module fixture
(``testing.parallel_cases``); the JAX package runs the same inputs on a
4-device subset of the conftest's 8-device CPU mesh. The inputs are those of
``tests/test_parallel.py``: its stiff chains (w = 10000 relative rows against
w ≈ 0.1 GNSS rows), its random bands and its sharded batch drive.

Tolerances are the JAX tests' own: 1e-8 relative for the solves' steps,
1e-10 for the halo matvec, 1e-8 for the PCG's x, and 1e-8 m in p, 1e-9 in
q, 1e-6 relative in the costs for ``optimize_batch_sharded``.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from glio_tpu.config import GlioConfig as JGlioConfig
from glio_tpu.data.simulator import simulate_gnss_epochs as j_simulate_gnss
from glio_tpu.models import batch as jbatch
from glio_tpu.parallel import banded_pcg as jpcg
from glio_tpu.parallel import spike_cr as jspike
from glio_tpu.solver import banded as jbanded
from glio_tpu_torch import testing
from glio_tpu_torch.config import GlioConfig
from glio_tpu_torch.data.simulator import simulate_gnss_epochs
from glio_tpu_torch.models import batch as tbatch
from glio_tpu_torch.parallel.launch import run_ranks
from glio_tpu_torch.solver import banded as tbanded
from test_parallel import _random_banded, _stiff_chain_band

RANKS = 4
STEP_RTOL = 1e-8


def _np(*arrays):
    return tuple(np.asarray(a) for a in arrays)


# (T, hw, seed): TestSpikeCR's chains, then 3 and 2 super-rows a rank (the
# second leaves the last rank only identity padding).
CR_CASES = ((257, 3, 7), (256, 3, 9), (20, 2, 3), (10, 2, 3))
HALO_CASES = ((16, 3, 2, 3), (8, 2, 1, 4))          # (T, D, hw, seed), TestHaloBoundary's


def _cases():
    return dict(
        cr=[(*_np(*_stiff_chain_band(T, hw, seed)), hw) for T, hw, seed in CR_CASES],
        halo=[(*_np(*_random_banded(T, D, hw, nb=1, seed=seed)), hw)
              for T, D, hw, seed in HALO_CASES],
        pcg=(*_np(*_random_banded(32, 6, 2, nb=2, seed=1)), 2, 120),
        pcg_sp1=(*_np(*_random_banded(16, 4, 2, nb=4, seed=2)), 2, 80),
        uneven=(*_np(*_random_banded(31, 4, 2, nb=2, seed=5)), 2, 10),   # 31 % 2 != 0
        batch=testing.SHARDED_DRIVE)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = _cases()
    init = str(tmp_path_factory.mktemp("rendezvous") / "init")
    return cases, run_ranks(testing.parallel_cases, RANKS, "cpu", init, args=(cases,))


def _mesh(*shape, names=("sp",)):
    return Mesh(np.array(jax.devices()[:RANKS]).reshape(shape), names)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def test_every_rank_returns_the_same(ranks):
    _, res = ranks
    assert len(res) == RANKS
    for r in res:
        assert r["jax_modules"] == []        # a rank imports nothing of JAX
    for r in res[1:]:
        for x0, x in zip(res[0]["cr"], r["cr"]):
            assert torch.equal(x0, x)
        for a, b in zip(res[0]["batch"][:2], r["batch"][:2]):
            assert torch.equal(a, b)
        assert torch.equal(res[0]["pcg"][0], r["pcg"][0])


@pytest.mark.parametrize("case", range(len(CR_CASES)),
                         ids=[f"T{T}_hw{hw}" for T, hw, _ in CR_CASES])
def test_sharded_cr_matches_jax(ranks, case):
    cases, res = ranks
    band, b, hw = cases["cr"][case]
    x = res[0]["cr"][case].numpy()
    x_jax = np.asarray(jspike.make_sharded_cr_solve(_mesh(RANKS), hw=hw)(
        jnp.asarray(band), jnp.asarray(b)))
    x_single = tbanded.cyclic_reduction_solve(torch.tensor(band), torch.tensor(b)).numpy()
    assert x.shape == b.shape
    assert _rel(x, x_jax) < STEP_RTOL
    assert _rel(x, x_single) < STEP_RTOL
    assert _rel(x, jbanded.cyclic_reduction_solve(jnp.asarray(band), jnp.asarray(b))) < STEP_RTOL
    r = b - tbanded.band_matvec(torch.tensor(band), torch.tensor(x)).numpy()
    assert np.abs(r).max() / max(np.abs(b).max(), 1.0) < 1e-6


@pytest.mark.parametrize("case", range(len(HALO_CASES)),
                         ids=[f"T{c[0]}_hw{c[2]}" for c in HALO_CASES])
def test_halo_matvec_matches_jax_at_the_edges(ranks, case):
    cases, res = ranks
    band, x, hw = cases["halo"][case]
    y = res[0]["halo"][case].numpy()
    mv = jax.jit(jax.shard_map(lambda bd, v: jpcg._halo_matvec(bd, v, hw, "sp"),
                               mesh=_mesh(RANKS), in_specs=(P(None, "sp"), P(None, "sp")),
                               out_specs=P(None, "sp")))
    np.testing.assert_allclose(y, np.asarray(mv(jnp.asarray(band), jnp.asarray(x))),
                               atol=1e-10)
    y_dense = tbanded.band_matvec(torch.tensor(band[0]), torch.tensor(x[0])).numpy()
    np.testing.assert_allclose(y[0], y_dense, atol=1e-10)
    # The rows whose band reaches outside the domain: the first and last shard's.
    np.testing.assert_allclose(y[0, [0, -1]], y_dense[[0, -1]], atol=1e-12)


@pytest.mark.parametrize("key,shape", [("pcg", (2, 2)), ("pcg_sp1", (RANKS, 1))])
def test_sharded_pcg_matches_jax(ranks, key, shape):
    cases, res = ranks
    band, b, hw, iters = cases[key]
    x, r = (a.numpy() for a in res[0][key])
    x_jax, r_jax = jpcg.make_sharded_pcg(_mesh(*shape, names=("dp", "sp")), hw=hw,
                                         iters=iters)(jnp.asarray(band), jnp.asarray(b))
    np.testing.assert_allclose(x, np.asarray(x_jax), atol=1e-8)
    assert r.shape == (b.shape[0],) and np.all(r < 1e-8) and np.all(np.asarray(r_jax) < 1e-8)
    for n in range(b.shape[0]):
        x_single, _ = tbanded.pcg_solve(torch.tensor(band[n]), torch.tensor(b[n]), iters=iters)
        np.testing.assert_allclose(x[n], x_single.numpy(), atol=1e-8)


def test_uneven_shard_raises_clear_error(ranks):
    cases, res = ranks
    band, b, hw, iters = cases["uneven"]
    assert res[0]["uneven"] is not None and "pad T to a multiple of sp" in res[0]["uneven"]
    with pytest.raises(ValueError, match="pad T to a multiple of sp"):
        jpcg.make_sharded_pcg(_mesh(2, 2, names=("dp", "sp")), hw=hw, iters=iters)(
            jnp.asarray(band), jnp.asarray(b))


def test_optimize_batch_sharded_matches_jax(ranks):
    _, res = ranks
    sc = testing.SHARDED_DRIVE
    p, q, costs = res[0]["batch"]
    kf_time, _, q_true, gnss, p_odo = testing.sharded_drive(sc, j_simulate_gnss)
    prob = jbatch.build_problem(JGlioConfig(), p_odo, q_true, kf_time, gnss,
                                testing.ANCHOR_ECEF, 0.0, testing.STATION_ECEF)
    p_j, q_j, c_j = jbatch.optimize_batch_sharded(
        JGlioConfig(), prob, _mesh(RANKS), thresholds=sc["thresholds"],
        lm_iters=sc["lm_iters"], robust=testing.robust_opts(jbatch, sc))
    np.testing.assert_allclose(p.numpy(), np.asarray(p_j), atol=1e-8)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), atol=1e-9)
    for c, cj in zip(costs, c_j):
        assert abs(c - cj) < 1e-6 * max(abs(cj), 1.0)
    # And against the port's own single-device solve.
    kf_time, _, q_true, gnss, p_odo = testing.sharded_drive(sc, simulate_gnss_epochs)
    cfg = GlioConfig()
    tprob = tbatch.build_problem(cfg, p_odo, q_true, kf_time, gnss, testing.ANCHOR_ECEF,
                                 0.0, testing.STATION_ECEF, device="cpu")
    p_s, q_s, c_s = tbatch.optimize_batch(cfg, tprob, thresholds=sc["thresholds"],
                                          lm_iters=sc["lm_iters"],
                                          robust=testing.robust_opts(tbatch, sc))
    np.testing.assert_allclose(p.numpy(), p_s.numpy(), atol=1e-8)
    np.testing.assert_allclose(q.numpy(), q_s.numpy(), atol=1e-9)


def test_a_failing_rank_fails_the_caller(tmp_path):
    # Rank 1 raises; rank 0, waiting in a collective, then loses its peer.
    # Whichever error the caller sees first is raised, and nothing hangs.
    t0 = time.perf_counter()
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="fails on purpose|by peer"):
        run_ranks(testing.failing_rank, 2, "cpu", str(tmp_path / "init"), args=(1,))
    assert time.perf_counter() - t0 < 120.0
