"""Port parity: the batch stage, level 0 (``models/batch.py``).

The problem is the JAX package's batch-test scenario at T = 60 keyframes
(``drifted_trajectory``: a 3 Hz drive with smoothly drifting odometry, and
``simulate_gnss_epochs(psr_noise=0.5, seed=4)`` every third keyframe, 20
epochs). ``glio_tpu`` builds and solves it in exact f64 (``mixed=False``,
the arithmetic the port runs); the port gets the same problem, through its
own ``build_problem`` and through ``convert.batch_problem_from_numpy``.

Tolerances: the problem's fields equal to 1e-12 (relative measurements
through torch and jnp quaternion products); band and gradient to 1e-12
relative to their largest entry (f64 sums in another order); the solved
trajectory to 1e-8 m and 1e-10 (the f64 solve damps a 1e-9 m nudge of the
odometry to ~1e-10 m, so what remains is round-off); covariances to 1e-8
relative (the rotation gauge is held only by a 1e-9 jitter).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glio_tpu.config import EstimatorConfig, GlioConfig
from glio_tpu.data.simulator import simulate_gnss_epochs
from glio_tpu.models import batch as JB
from glio_tpu_torch import convert
from glio_tpu_torch.data.simulator import drifted_trajectory
from glio_tpu_torch.models import batch as TB

ANCHOR = np.array([-2419233.42, 5385473.13, 2405341.30])
STATION = np.array([-2414266.92, 5386768.987, 2407460.031])
CFG = GlioConfig()
TCFG = convert.config_from_glio(CFG)
HW = CFG.estimator.search_range + 1
ROBUST = dict(dd_huber=1.0, epoch_gate=2.0, rel_huber=5.0)


@pytest.fixture(scope="module")
def scenario():
    kf_time, p_true, q_true, p_odo = drifted_trajectory(60)
    gnss = simulate_gnss_epochs(p_true, kf_time, ANCHOR, STATION, psr_noise=0.5, seed=4)
    prob_j = JB.build_problem(CFG, p_odo, q_true, kf_time, gnss, ANCHOR, 0.0, STATION)
    prob_t = convert.batch_problem_from_numpy(jax.tree.map(np.asarray, prob_j), "cpu")
    return dict(kf_time=kf_time, p_true=p_true, q_true=q_true, p_odo=p_odo,
                gnss=gnss, prob_j=prob_j, prob_t=prob_t)


def test_despike_trajectory_matches_jax():
    """The JAX package's despike test case: a 2-keyframe spike and an
    isolated one are repaired; a clean trajectory is a no-op."""
    T = 60
    kf_time = np.arange(T) / 3.0
    p = np.stack([10 * kf_time, np.zeros(T), np.zeros(T)], -1)
    q = np.tile([1.0, 0, 0, 0], (T, 1))
    p_bad = p.copy()
    p_bad[20:22] += np.array([300.0, -200.0, 150.0])
    p_bad[40] += np.array([-500.0, 0.0, 80.0])
    p_bad[-1] += np.array([0.0, 90.0, 0.0])               # trailing spike
    p_t, q_t, n_t = TB.despike_trajectory(p_bad, q, kf_time)
    p_j, q_j, n_j = JB.despike_trajectory(p_bad, q, kf_time)
    assert n_t == n_j >= 4
    np.testing.assert_array_equal(p_t, p_j)
    np.testing.assert_array_equal(q_t, q_j)
    np.testing.assert_allclose(p_t[:-1], p[:-1], atol=1e-6)
    assert TB.despike_trajectory(p, q, kf_time)[2] == 0


def test_build_problem_field_by_field(scenario):
    s = scenario
    prob = TB.build_problem(TCFG, s["p_odo"], s["q_true"], s["kf_time"],
                            convert.gnss_from_numpy(s["gnss"]), ANCHOR, 0.0, STATION,
                            device="cpu")
    ref = jax.tree.map(np.asarray, s["prob_j"])
    for f in TB.BatchProblem._fields:
        got, want = getattr(prob, f).numpy(), getattr(ref, f)
        assert got.shape == want.shape, f
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12, err_msg=f)
    assert prob.ep_left.dtype == torch.int64 and prob.master.dtype == torch.int64
    assert int(prob.ep_valid.sum()) == 20


@pytest.mark.parametrize("robust", [False, True])
def test_assembly_matches_jax(scenario, robust):
    """Band, gradient, cost and IRLS weights at a perturbed trajectory,
    threshold 6 (so the ×0.05 anneal engages on some rows)."""
    s = scenario
    rng = np.random.default_rng(7)
    p = s["p_odo"] + rng.normal(0, 2.0, size=s["p_odo"].shape)
    q = s["q_true"]
    if robust:
        out_j = JB._assemble_core_impl(jnp.asarray(p), jnp.asarray(q), s["prob_j"],
                                       jnp.asarray(6.0), HW, robust=JB.RobustOpts(**ROBUST),
                                       mixed=False)
        out_t = TB._assemble_core_impl(torch.tensor(p), torch.tensor(q), s["prob_t"], 6.0,
                                       HW, robust=TB.RobustOpts(**ROBUST))
    else:
        out_j = JB._assemble_core_impl(jnp.asarray(p), jnp.asarray(q), s["prob_j"],
                                       jnp.asarray(6.0), HW, mixed=False)
        out_t = TB._assemble_core_impl(torch.tensor(p), torch.tensor(q), s["prob_t"], 6.0, HW)
    band_j, grad_j, cost_j, wr_j, wd_j = (np.asarray(a) for a in out_j)
    band_t, grad_t, cost_t, wr_t, wd_t = (a.numpy() for a in out_t)
    assert band_t.shape == band_j.shape == (60, 2 * HW + 1, 6, 6)
    np.testing.assert_allclose(band_t, band_j, rtol=0, atol=1e-12 * np.abs(band_j).max())
    np.testing.assert_allclose(grad_t, grad_j, rtol=0, atol=1e-12 * np.abs(grad_j).max())
    np.testing.assert_allclose(cost_t, cost_j, rtol=1e-12)
    np.testing.assert_allclose(wr_t, wr_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(wd_t, wd_j, rtol=0, atol=1e-12)
    if robust:
        assert (wd_t < 1).any() and (wr_t <= 1).all()


def test_total_cost_matches_jax(scenario):
    s = scenario
    p = s["p_odo"] + 0.5
    for th in (1e9, 6.0):
        c_j = float(JB._total_cost(jnp.asarray(p), jnp.asarray(s["q_true"]), s["prob_j"],
                                   jnp.asarray(th)))
        c_t = float(TB._total_cost(torch.tensor(p), torch.tensor(s["q_true"]), s["prob_t"], th))
        assert c_t == pytest.approx(c_j, rel=1e-12)


@pytest.fixture(scope="module")
def solved(scenario):
    s = scenario
    kw = dict(thresholds=(1e9, 6.0), lm_iters=3)
    p_j, q_j, c_j = JB.optimize_batch(CFG, s["prob_j"], robust=JB.RobustOpts(**ROBUST),
                                      mixed=False, **kw)
    p_t, q_t, c_t = TB.optimize_batch(TCFG, s["prob_t"], robust=TB.RobustOpts(**ROBUST), **kw)
    return np.asarray(p_j), np.asarray(q_j), c_j, p_t, q_t, c_t


def test_optimize_batch_matches_jax_f64(scenario, solved):
    p_j, q_j, c_j, p_t, q_t, c_t = solved
    np.testing.assert_allclose(p_t.numpy(), p_j, rtol=0, atol=1e-8)
    np.testing.assert_allclose(q_t.numpy(), q_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(c_t, c_j, rtol=1e-10)
    # The solve moved the drifted odometry toward the truth.
    err = lambda p: np.sqrt(np.mean(np.sum((p - scenario["p_true"]) ** 2, -1)))
    assert err(p_t.numpy()) < err(scenario["p_odo"])


def test_pcg_solver_and_warm_start(scenario, solved):
    """solver="pcg" runs the same LM with block-Jacobi PCG steps: from the
    same warm start it follows the direct solver's iterates."""
    _, _, _, p_t, q_t, _ = solved
    kw = dict(thresholds=(6.0,), lm_iters=2, init=(p_t, q_t), robust=TB.RobustOpts(**ROBUST))
    p_d, _, c_d = TB.optimize_batch(TCFG, scenario["prob_t"], **kw)
    p_p, _, c_p = TB.optimize_batch(TCFG, scenario["prob_t"], solver="pcg",
                                    pcg_iters=400, **kw)
    np.testing.assert_allclose(p_p.numpy(), p_d.numpy(), rtol=0, atol=1e-9)
    assert c_p[0] == pytest.approx(c_d[0], rel=1e-12)


def test_covariances_match_jax(scenario, solved):
    s = scenario
    p_j, q_j, _, p_t, q_t, _ = solved
    cov_j = JB.batch_marginal_covariance(CFG, s["prob_j"], jnp.asarray(p_j), jnp.asarray(q_j))
    cov_t = TB.batch_marginal_covariance(TCFG, s["prob_t"], p_t, q_t)
    cov_j = np.asarray(cov_j)
    assert cov_t.shape == (60, 6, 6)
    np.testing.assert_allclose(cov_t.numpy(), cov_j, rtol=0, atol=1e-8 * np.abs(cov_j).max())
    cal_j, rep_j = JB.calibrate_batch_covariance(CFG, s["prob_j"], jnp.asarray(p_j),
                                                 jnp.asarray(q_j), cov_j)
    cal_t, rep_t = TB.calibrate_batch_covariance(TCFG, s["prob_t"], p_t, q_t, cov_t)
    assert rep_t["calibrated"] and rep_j["calibrated"]
    assert rep_t["n_epochs"] == rep_j["n_epochs"] == 20
    np.testing.assert_allclose(cal_t.numpy(), np.asarray(cal_j), rtol=0,
                               atol=1e-8 * np.abs(cal_j).max())
    assert rep_t["median_bias_3d"] == pytest.approx(rep_j["median_bias_3d"], rel=1e-8)


def test_calibration_skips_with_few_epochs(scenario, solved):
    s = scenario
    _, _, _, p_t, q_t, _ = solved
    few = s["prob_t"]._replace(ep_valid=s["prob_t"].ep_valid & (torch.arange(20) < 5))
    cov = torch.eye(6, dtype=torch.float64).expand(60, 6, 6)
    cal, rep = TB.calibrate_batch_covariance(TCFG, few, p_t, q_t, cov)
    assert not rep["calibrated"] and rep["n_epochs"] == 5
    np.testing.assert_array_equal(cal.numpy(), cov.numpy())


@pytest.mark.parametrize("case", ["doppler_in_batch", "chol_pcg", "unknown_solver"])
def test_unported_options_raise(scenario, case):
    """The two options this test once saw refused now run and match JAX
    (f64) after one LM iteration at threshold 6 (``tests/test_torch_batch_doppler.py``
    holds them in full); an unknown solver still raises."""
    prob = scenario["prob_t"]
    if case == "unknown_solver":
        with pytest.raises(ValueError):
            TB.solve_batch_once(TCFG, prob, prob.p_odo, prob.q_odo, 6.0, solver="lu")
        return
    est = dataclasses.replace(CFG.estimator, doppler_in_batch=case == "doppler_in_batch")
    cfg = CFG.replace(estimator=est)
    solver = "chol_pcg" if case == "chol_pcg" else "direct"
    kw = dict(thresholds=(6.0,), lm_iters=1, solver=solver)
    p_j, _, c_j = JB.optimize_batch(cfg, scenario["prob_j"], mixed=False, **kw)
    p_t, _, c_t = TB.optimize_batch(convert.config_from_glio(cfg), prob, **kw)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0, atol=1e-8)
    assert c_t[0] == pytest.approx(c_j[0], rel=1e-10)


def test_batch_problem_from_numpy_dtypes(scenario):
    prob = scenario["prob_t"]
    assert prob.ep_left.dtype == torch.int64 and prob.system.dtype == torch.int32
    assert prob.rel_valid.dtype == torch.bool and prob.whiten.dtype == torch.float64
    assert EstimatorConfig().search_range == prob.rel_valid.shape[1]
