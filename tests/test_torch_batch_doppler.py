"""Port parity: the batch stage's Doppler rows (``doppler_in_batch``,
``models/batch.py``). The ``chol_pcg`` solver is
``tests/test_torch_batch_chol_pcg.py``'s, on this file's scenario.

The problem is ``tests/test_torch_batch.py``'s: the JAX package's batch-test
scenario at T = 60 keyframes (``drifted_trajectory``) with
``simulate_gnss_epochs(psr_noise=0.5, seed=4)`` every third keyframe, whose
Doppler is the true range rate plus the receiver clock drift. ``glio_tpu``
runs in exact f64 (``mixed=False``, the port's arithmetic).

Tolerances: the Doppler rows to 1e-10 (whitened, O(1) values; f64 sums in
another order); band, gradient and cost to 1e-12 of their largest entry, as
the DD assembly; ``optimize_batch`` with Doppler rows to 1e-8 m and 1e-10,
as without them (the direct solve damps round-off).
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
from glio_tpu_torch import convert
from glio_tpu_torch.data.simulator import drifted_trajectory
from glio_tpu_torch.models import batch as TB

ANCHOR = np.array([-2419233.42, 5385473.13, 2405341.30])
STATION = np.array([-2414266.92, 5386768.987, 2407460.031])
CFG = GlioConfig().replace(estimator=dataclasses.replace(GlioConfig().estimator,
                                                         doppler_in_batch=True))
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
