"""Port parity: the batch stage's Doppler rows (``doppler_in_batch``) and the
``chol_pcg`` solver (``models/batch.py``, ``solver/banded.py``).

The problem is ``tests/test_torch_batch.py``'s: the JAX package's batch-test
scenario at T = 60 keyframes (``drifted_trajectory``) with
``simulate_gnss_epochs(psr_noise=0.5, seed=4)`` every third keyframe, whose
Doppler is the true range rate plus the receiver clock drift. ``glio_tpu``
runs in exact f64 (``mixed=False``, the port's arithmetic).

Tolerances: the Doppler rows to 1e-10 (whitened, O(1) values; f64 sums in
another order); band, gradient and cost to 1e-12 of their largest entry, as
the DD assembly; ``optimize_batch`` with Doppler rows to 1e-8 m and 1e-10,
as without them (the direct solve damps round-off); with ``chol_pcg``, JAX's
own result moves by up to 8.4e-10 m under a ±1e-9 m nudge of the odometry
(the f32 preconditioner's rounding; measured on this scenario), so the port
is held to 1e-8 m of it, about 10x that spread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glio_tpu.config import GlioConfig
from glio_tpu.data.simulator import simulate_gnss_epochs
from glio_tpu.models import batch as JB
from glio_tpu.solver import banded as JBand
from glio_tpu_torch import convert
from glio_tpu_torch.data.simulator import drifted_trajectory
from glio_tpu_torch.models import batch as TB
from glio_tpu_torch.solver import banded as TBand

ANCHOR = np.array([-2419233.42, 5385473.13, 2405341.30])
STATION = np.array([-2414266.92, 5386768.987, 2407460.031])
CFG = GlioConfig().replace(estimator=dataclasses.replace(GlioConfig().estimator,
                                                         doppler_in_batch=True))
TCFG = convert.config_from_glio(CFG)
HW = CFG.estimator.search_range + 1
ROBUST = dict(dd_huber=1.0, epoch_gate=2.0, rel_huber=5.0)
CHOL_PCG_TOL_M = 1e-8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The band factors here make thousands of 6 x 6 Cholesky calls, which
    MKL's threaded LAPACK takes milliseconds each to run and one thread a
    few microseconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenario():
    kf_time, p_true, q_true, p_odo = drifted_trajectory(60)
    gnss = simulate_gnss_epochs(p_true, kf_time, ANCHOR, STATION, psr_noise=0.5, seed=4)
    prob_j = JB.build_problem(CFG, p_odo, q_true, kf_time, gnss, ANCHOR, 0.0, STATION)
    prob_t = convert.batch_problem_from_numpy(jax.tree.map(np.asarray, prob_j), "cpu")
    return dict(kf_time=kf_time, p_true=p_true, q_true=q_true, p_odo=p_odo,
                prob_j=prob_j, prob_t=prob_t)


def _perturbed(s, seed=7):
    rng = np.random.default_rng(seed)
    return s["p_odo"] + rng.normal(0, 2.0, size=s["p_odo"].shape)


def test_dopp_residuals_match_jax(scenario):
    s = scenario
    p = _perturbed(s)
    pj = s["prob_j"]
    r_j = np.asarray(JB._dopp_residuals(jnp.asarray(p), pj, pj.sat_vel, pj.sat_ddt, pj.dopp))
    r_t = TB._dopp_residuals(torch.tensor(p), s["prob_t"]).numpy()
    assert r_t.shape == r_j.shape == (20, 32)
    np.testing.assert_allclose(r_t, r_j, rtol=0, atol=1e-10)
    assert (np.abs(r_t) > 1e-3).sum() > 100          # the rows engage


def test_dopp_jacobian_aliased_ends(scenario):
    """At the chain's ends two of the four poses coincide (li−1 clamps to
    li, li+2 to li+1): each slot's delta moves the pose in both of its
    uses, as the JAX package's scatter-added deltas do, so each aliased
    slot's column is the whole derivative; against central differences."""
    s = scenario
    prob = s["prob_t"]._replace(ep_left=torch.tensor([0] + [3 * k for k in range(1, 19)] + [58]))
    p = torch.tensor(_perturbed(s))
    res, J4, idx4 = TB._dopp_row_jac(p, prob)
    assert idx4[0, 0] == idx4[0, 1] == 0 and idx4[-1, 2] == idx4[-1, 3] == 59
    for e in (0, 19):
        for a in range(4):
            for k in range(3):
                h = 1e-4
                dp = torch.zeros_like(p)
                dp[idx4[e, a], k] = h
                fd = (TB._dopp_residuals(p + dp, prob) - TB._dopp_residuals(p - dp, prob))[e] / (2 * h)
                np.testing.assert_allclose(J4[e, :, a, k].numpy(), fd.numpy(),
                                           rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("robust", [False, True])
def test_assembly_with_doppler_matches_jax(scenario, robust):
    """Band, gradient and cost with the Doppler rows' 16 couplings, at a
    perturbed trajectory, threshold 6."""
    s = scenario
    p = _perturbed(s)
    q = s["q_true"]
    kw_j = dict(robust=JB.RobustOpts(**ROBUST)) if robust else {}
    kw_t = dict(robust=TB.RobustOpts(**ROBUST)) if robust else {}
    out_j = JB._assemble_core_impl(jnp.asarray(p), jnp.asarray(q), s["prob_j"], jnp.asarray(6.0),
                                   HW, use_doppler=True, mixed=False, **kw_j)
    out_t = TB._assemble_core_impl(torch.tensor(p), torch.tensor(q), s["prob_t"], 6.0, HW,
                                   use_doppler=True, **kw_t)
    band_j, grad_j, cost_j = (np.asarray(a) for a in out_j[:3])
    band_t, grad_t, cost_t = (a.numpy() for a in out_t[:3])
    np.testing.assert_allclose(band_t, band_j, rtol=0, atol=1e-12 * np.abs(band_j).max())
    np.testing.assert_allclose(grad_t, grad_j, rtol=0, atol=1e-12 * np.abs(grad_j).max())
    np.testing.assert_allclose(cost_t, cost_j, rtol=1e-12)
    # The Doppler rows reach three block rows off the diagonal.
    band_no, _, cost_no, _, _ = TB._assemble_core_impl(torch.tensor(p), torch.tensor(q),
                                                       s["prob_t"], 6.0, HW, **kw_t)
    assert float(cost_t) > float(cost_no)
    assert np.abs(band_t[:, HW + 3] - band_no.numpy()[:, HW + 3]).max() > 0


def test_total_cost_with_doppler_matches_jax(scenario):
    s = scenario
    p = s["p_odo"] + 0.5
    c_j = float(JB._total_cost(jnp.asarray(p), jnp.asarray(s["q_true"]), s["prob_j"],
                               jnp.asarray(6.0), use_doppler=True))
    c_t = float(TB._total_cost(torch.tensor(p), torch.tensor(s["q_true"]), s["prob_t"], 6.0,
                               use_doppler=True))
    assert c_t == pytest.approx(c_j, rel=1e-12)


@pytest.fixture(scope="module")
def solved(scenario):
    s = scenario
    kw = dict(thresholds=(1e9, 6.0), lm_iters=3)
    p_j, q_j, c_j = JB.optimize_batch(CFG, s["prob_j"], robust=JB.RobustOpts(**ROBUST),
                                      mixed=False, **kw)
    p_t, q_t, c_t = TB.optimize_batch(TCFG, s["prob_t"], robust=TB.RobustOpts(**ROBUST), **kw)
    return np.asarray(p_j), np.asarray(q_j), c_j, p_t, q_t, c_t


def test_optimize_batch_doppler_matches_jax(scenario, solved):
    p_j, q_j, c_j, p_t, q_t, c_t = solved
    np.testing.assert_allclose(p_t.numpy(), p_j, rtol=0, atol=1e-8)
    np.testing.assert_allclose(q_t.numpy(), q_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(c_t, c_j, rtol=1e-10)
    err = lambda p: np.sqrt(np.mean(np.sum((p - scenario["p_true"]) ** 2, -1)))
    assert err(p_t.numpy()) < err(scenario["p_odo"])


def test_covariance_with_doppler_matches_jax(scenario, solved):
    s = scenario
    p_j, q_j, _, p_t, q_t, _ = solved
    cov_j = np.asarray(JB.batch_marginal_covariance(CFG, s["prob_j"], jnp.asarray(p_j),
                                                    jnp.asarray(q_j)))
    cov_t = TB.batch_marginal_covariance(TCFG, s["prob_t"], p_t, q_t).numpy()
    np.testing.assert_allclose(cov_t, cov_j, rtol=0, atol=1e-8 * np.abs(cov_j).max())


@pytest.fixture(scope="module")
def stiff_band():
    """A long stiff chain where 14 CG iterations stop short: the Doppler
    batch's band at T = 300 (the truth, threshold 6, the bench robust
    options, damping 1e-6), on which JAX's ``chol_pcg`` lies 2.7e-3 of |x|
    from the exact step."""
    T = 300
    kf_time, p_true, q_true, p_odo = drifted_trajectory(T)
    gnss = simulate_gnss_epochs(p_true, kf_time, ANCHOR, STATION, psr_noise=0.5, seed=4)
    prob_j = JB.build_problem(CFG, p_odo, q_true, kf_time, gnss, ANCHOR, 0.0, STATION)
    prob_t = convert.batch_problem_from_numpy(jax.tree.map(np.asarray, prob_j), "cpu")
    band, grad, *_ = TB._assemble_core_impl(torch.tensor(p_true), torch.tensor(q_true), prob_t,
                                            6.0, HW, robust=TB.RobustOpts(**ROBUST),
                                            use_doppler=True)
    TB._damp(band, torch.tensor(1e-6, dtype=torch.float64), HW)
    return band, -grad


def _jax_precond(band):
    """JAX's equilibrated f32 factor (broken rows the identity, as in
    ``_f32_chol_precond``) and its apply."""
    band_j = jnp.asarray(band.numpy())
    Lb = np.array(JBand.block_cholesky(JBand._equilibrate(band_j)[0].astype(jnp.float32),
                                       jitter=3e-4))
    bad = ~np.isfinite(Lb).all(axis=(1, 2, 3))
    Lb[bad] = 0.0
    Lb[bad, 0] = np.eye(Lb.shape[-1])
    apply = JBand._f32_chol_precond(band_j)
    return Lb, bad, lambda r: np.asarray(apply(jnp.asarray(r)))


def _rel(a, ref):
    return np.abs(a - ref).max() / np.abs(ref).max()


def _block_row_apply(M, r):
    """``_f32_chol_precond``'s apply with the port's factor: the f32
    ``block_cholesky_solve`` of the equilibrated right-hand side."""
    return (TBand.block_cholesky_solve(M.Lb, (r * M.s).to(torch.float32)).double() * M.s).numpy()


def test_f32_chol_precond_matches_jax(stiff_band):
    """``f32_chol_precond`` is ``block_cholesky`` of the equilibrated f32
    band, bit for bit, and within f32 round-off of JAX's factor (5.1e-6 of
    its largest entry, measured); its apply is that factor's block-row
    solve in f32, bit for bit, and within 2e-5 of JAX's apply (relative
    max-norm). A factor taken one 42 x 42 super-row at a time lies 1.1e-4
    from JAX's apply here, and fails."""
    band, b = stiff_band
    Lb_j, bad_j, apply_j = _jax_precond(band)
    assert not bad_j.any()
    M = TBand.f32_chol_precond(band)
    band_s, s = TBand._equilibrate(band)
    assert torch.equal(M.s, s)
    assert torch.equal(M.Lb, TBand.block_cholesky(band_s.to(torch.float32), jitter=3e-4))
    assert _rel(M.Lb.numpy(), Lb_j) < 2e-5
    r = torch.tensor(np.random.default_rng(0).normal(size=tuple(b.shape)))
    z = TBand.f32_chol_apply(M, r).numpy()
    np.testing.assert_array_equal(z, _block_row_apply(M, r))
    assert _rel(z, apply_j(r.numpy())) < 2e-5


def test_pcg_chol_solve_unconverged_matches_jax(stiff_band):
    """On the stiff chain the 14 iterations stop 9.4e-3 short of the exact
    step (|x| 3.5); the port's result lies 5.0e-6 from JAX's (measured)."""
    band, b = stiff_band
    x_j = np.asarray(JBand.pcg_chol_solve(jnp.asarray(band.numpy()), jnp.asarray(b.numpy())))
    x = TBand.direct_solve(band, b).numpy()
    assert _rel(x_j, x) > 1e-3
    x_t = TBand.pcg_chol_solve(band, b).numpy()
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=2e-5)


def _broken(band):
    """The band with block row 150's diagonal block negated: indefinite."""
    band = band.clone()
    band[150, HW] = -band[150, HW]
    return band


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_block_cholesky_breakdown_stays_in_its_row(stiff_band, dtype):
    """A block row whose Schur complement is indefinite gives NaN in that
    row alone: JAX's column guard zeroes it below, and so does the port's."""
    band = _broken(stiff_band[0])
    band_s, _ = TBand._equilibrate(band)
    L_j = np.asarray(JBand.block_cholesky(jnp.asarray(band_s.to(dtype).numpy()),
                                          jitter=3e-4))
    L_t = TBand.block_cholesky(band_s.to(dtype), jitter=3e-4).numpy()
    bad_j = ~np.isfinite(L_j).all(axis=(1, 2, 3))
    bad_t = ~np.isfinite(L_t).all(axis=(1, 2, 3))
    assert np.nonzero(bad_j)[0].tolist() == [150]
    np.testing.assert_array_equal(bad_t, bad_j)
    for m in range(1, HW + 1):       # L[150 + m][150], column 150 below the break
        assert np.all(L_t[150 + m, m] == 0) and np.all(L_j[150 + m, m] == 0)


def test_f32_chol_precond_breakdown_matches_jax(stiff_band):
    """The broken block row becomes the identity, as in JAX, and the apply,
    still the f32 block-row solve bit for bit, matches JAX's."""
    band = _broken(stiff_band[0])
    Lb_j, bad_j, apply_j = _jax_precond(band)
    M = TBand.f32_chol_precond(band)
    assert np.nonzero(bad_j)[0].tolist() == [150]
    np.testing.assert_array_equal(M.Lb[150].numpy(), Lb_j[150])
    assert _rel(M.Lb.numpy(), Lb_j) < 2e-5
    r = np.random.default_rng(1).normal(size=tuple(stiff_band[1].shape))
    z = TBand.f32_chol_apply(M, torch.tensor(r)).numpy()
    np.testing.assert_array_equal(z, _block_row_apply(M, torch.tensor(r)))
    assert _rel(z, apply_j(r)) < 2e-5


def test_pcg_chol_solve_matches_jax():
    """The f32-preconditioned CG on a banded SPD system (hw 3, 50 block
    rows), where 14 iterations converge, 14 iterations each."""
    rng = np.random.default_rng(0)
    T, hw, D = 50, 3, 6
    n = T * D
    J = np.zeros((n + 30, n))
    for r in range(J.shape[0]):
        c = rng.integers(0, n - hw * D)
        J[r, c:c + hw * D] = rng.normal(size=hw * D) * rng.choice([1.0, 3.0, 10.0])
    H = J.T @ J + 0.1 * np.eye(n)
    band = np.zeros((T, 2 * hw + 1, D, D))
    for t in range(T):
        for o in range(2 * hw + 1):
            j = t + o - hw
            if 0 <= j < T:
                band[t, o] = H[t * D:(t + 1) * D, j * D:(j + 1) * D]
    b = rng.normal(size=(T, D))
    x_j = np.asarray(JBand.pcg_chol_solve(jnp.asarray(band), jnp.asarray(b)))
    x_t = TBand.pcg_chol_solve(torch.tensor(band), torch.tensor(b)).numpy()
    x = np.linalg.solve(H, b.reshape(-1)).reshape(T, D)
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(x_t, x, rtol=0, atol=1e-7 * np.abs(x).max())


@pytest.mark.parametrize("doppler", [False, True], ids=["dd", "dd_doppler"])
def test_optimize_batch_chol_pcg_matches_jax(scenario, doppler):
    s = scenario
    est = dataclasses.replace(CFG.estimator, doppler_in_batch=doppler, batch_solver="chol_pcg")
    cfg = CFG.replace(estimator=est)
    kw = dict(thresholds=(1e9, 6.0), lm_iters=3, solver="chol_pcg")
    p_j, q_j, _ = JB.optimize_batch(cfg, s["prob_j"], robust=JB.RobustOpts(**ROBUST),
                                    mixed=False, **kw)
    p_t, q_t, _ = TB.optimize_batch(convert.config_from_glio(cfg), s["prob_t"],
                                    robust=TB.RobustOpts(**ROBUST), **kw)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0, atol=CHOL_PCG_TOL_M)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), rtol=0, atol=CHOL_PCG_TOL_M / 10)
