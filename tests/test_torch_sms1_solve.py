"""Port parity: batch level 1's solves and pipeline (``sms_fusion_level=1``).

``build_imu_chain``, ``optimize_batch_sms1`` and ``optimize_batch_sms1_imu``
against JAX's f64 solves (``mixed=False``, the port's arithmetic) on the
JAX package's IMU-chain test problem (``tests/test_batch.py``, seed 9,
30 keyframes), with JAX's correspondences handed to both solvers; and
``run_pipeline`` with level 1 against JAX's on the 10-keyframe episode of
the JAX package's level-1 pipeline test. The association's own parity is
in ``tests/test_torch_sms1.py``.

Tolerances. Given the same correspondences the solves agree to f64
round-off carried through 10 LM iterations (1e-8 m). The 10-keyframe
pipeline is far from converged and its level-1 result is sensitive to the
association's near-ties: JAX's own f64 result moves 4.1e-3 m when its
stage-1 trajectory is nudged by -1e-9 m and associated again (CPU,
measured once), so the port is held to 10x that, 4e-2 m.
"""

import functools
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glio_tpu.config import EstimatorConfig, GlioConfig, ShapeConfig
from glio_tpu.data.simulator import simulate_episode as jax_simulate_episode
from glio_tpu.data.simulator import simulate_gnss_epochs as jax_simulate_gnss
from glio_tpu.models import batch as JB
from glio_tpu.pipeline import run_pipeline as jax_run_pipeline
from glio_tpu_torch import convert
from glio_tpu_torch.data.simulator import simulate_episode, simulate_gnss_epochs
from glio_tpu_torch.models import batch as TB
from glio_tpu_torch.pipeline import run_pipeline

ANCHOR = np.array([-2419233.42, 5385473.13, 2405341.30])
STATION = np.array([-2414266.92, 5386768.987, 2407460.031])
CFG = GlioConfig().replace(estimator=EstimatorConfig(search_range=3, sms_fusion_level=1))
TCFG = convert.config_from_glio(CFG)


# --- the solves ------------------------------------------------------------------

@pytest.fixture(scope="module")
def imu_problem():
    """tests/test_batch.py's level-1-with-IMU scenario (seed 9), with JAX's
    correspondences handed to both solvers."""
    ep = jax_simulate_episode(n_keyframes=30, scan_points=512, seed=9, scan_noise=0.01,
                              q_lb=(1, 0, 0, 0), t_lb=(0, 0, 0))
    gnss = jax_simulate_gnss(ep.gt_p, ep.kf_time, ANCHOR, STATION, psr_noise=0.5, seed=9)
    rng = np.random.default_rng(9)
    p_odo = ep.gt_p + 1.5 * rng.normal(size=ep.gt_p.shape)
    prob = JB.build_problem(CFG, p_odo, ep.gt_q, ep.kf_time, gnss, ANCHOR, 0.0, STATION,
                            despike=False)
    sms = JB.build_sms1(CFG, ep.scan, ep.scan_valid, ep.gt_p, ep.gt_q, chunk=32)
    chain = JB.build_imu_chain(CFG, ep.imu_acc, ep.imu_gyr, ep.imu_dt, ep.imu_valid)
    chain_t = TB.build_imu_chain(TCFG, ep.imu_acc, ep.imu_gyr, ep.imu_dt, ep.imu_valid,
                                 device="cpu")
    prob_t = convert.batch_problem_from_numpy(jax.tree.map(np.asarray, prob), "cpu")
    sms_t = TB.Sms1Data(*(torch.as_tensor(np.asarray(a)) for a in sms))
    return ep, prob, sms, chain, prob_t, sms_t, chain_t


def test_build_imu_chain_matches_jax(imu_problem):
    _, _, _, chain, _, _, chain_t = imu_problem
    np.testing.assert_array_equal(chain_t.valid.numpy(), np.asarray(chain.valid))
    assert chain_t.valid.all() and chain_t.sqrt_info.shape == (29, 15, 15)
    for f in ("delta_p", "delta_q", "delta_v", "jacobian", "sum_dt"):
        want = np.asarray(getattr(chain.pres, f))
        np.testing.assert_allclose(getattr(chain_t.pres, f).numpy(), want, rtol=0,
                                   atol=1e-12 * max(np.abs(want).max(), 1.0), err_msg=f)
    S = np.asarray(chain.sqrt_info)
    np.testing.assert_allclose(chain_t.sqrt_info.numpy(), S, rtol=0, atol=1e-12 * np.abs(S).max())


def test_optimize_batch_sms1_matches_jax(imu_problem):
    _, prob, sms, _, prob_t, sms_t, _ = imu_problem
    p_j, q_j, c_j = JB.optimize_batch_sms1(CFG, prob, sms, thresholds=(1e9, 10.0),
                                           lm_iters=5, mixed=False)
    p_t, q_t, c_t = TB.optimize_batch_sms1(TCFG, prob_t, sms_t, thresholds=(1e9, 10.0),
                                           lm_iters=5)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0, atol=1e-8)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(c_t, c_j, rtol=1e-12)


@pytest.mark.parametrize("v0", ["odometry", "truth"])
def test_optimize_batch_sms1_imu_matches_jax(imu_problem, v0):
    """Given JAX's velocities the chain pulls harder (cost 1.6e3 → 1.6e3 over
    10 iterations, p within 1e-8 m); the default starts from differences of
    the odometry."""
    ep, prob, sms, chain, prob_t, sms_t, chain_t = imu_problem
    kw = dict(thresholds=(1e9, 10.0), lm_iters=5)
    v = None if v0 == "odometry" else ep.gt_v
    out_j = JB.optimize_batch_sms1_imu(CFG, prob, sms, chain, v0=v, mixed=False, **kw)
    out_t = TB.optimize_batch_sms1_imu(TCFG, prob_t, sms_t, chain_t, v0=v, **kw)
    for name, a, b, tol in zip(("p", "q", "v", "ba", "bg"), out_t[:5], out_j[:5],
                               (1e-8, 1e-10, 1e-9, 1e-9, 1e-10)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol, err_msg=name)
    np.testing.assert_allclose(out_t[5], out_j[5], rtol=1e-10)
    e0 = np.linalg.norm(prob_t.p_odo.numpy() - ep.gt_p, axis=-1).mean()
    assert np.linalg.norm(out_t[0].numpy() - ep.gt_p, axis=-1).mean() < 0.7 * e0


def test_initial_velocity_matches_jax(imu_problem):
    _, prob, _, _, prob_t, _, _ = imu_problem
    want = np.asarray(jnp.gradient(prob.p_odo, axis=0) / jnp.maximum(prob.kf_dt, 1e-3))
    np.testing.assert_allclose(TB.initial_velocity(prob_t).numpy(), want, rtol=1e-15)


@pytest.mark.parametrize("solver", ["pcg", "chol_pcg"])
@pytest.mark.parametrize("solve", ["pose", "imu"])
def test_level1_iterative_solvers_match_jax(imu_problem, solve, solver):
    """Level 1's ``pcg`` (200 block-Jacobi iterations) and ``chol_pcg``
    (14 CG iterations on the f32 band factor: D = 6, or 15 with the IMU
    chains) against JAX's f64 solves with the same correspondences. Both
    stop short of the exact step, so round-off steers them further than the
    direct solve: measured at most 8.7e-9 m (the 15-dof ``chol_pcg``), held
    to 1e-6 m (q 1e-8, v 1e-6)."""
    ep, prob, sms, chain, prob_t, sms_t, chain_t = imu_problem
    kw = dict(thresholds=(1e9, 10.0), lm_iters=4, solver=solver)
    if solve == "pose":
        out_j = JB.optimize_batch_sms1(CFG, prob, sms, mixed=False, **kw)
        out_t = TB.optimize_batch_sms1(TCFG, prob_t, sms_t, **kw)
        names = ("p", "q")
    else:
        out_j = JB.optimize_batch_sms1_imu(CFG, prob, sms, chain, mixed=False, **kw)
        out_t = TB.optimize_batch_sms1_imu(TCFG, prob_t, sms_t, chain_t, **kw)
        names = ("p", "q", "v")
    for name, a, b, tol in zip(names, out_t, out_j, (1e-6, 1e-8, 1e-6)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol, err_msg=name)
    np.testing.assert_allclose(out_t[-1], out_j[-1], rtol=1e-8)
    e0 = np.linalg.norm(prob_t.p_odo.numpy() - ep.gt_p, axis=-1).mean()
    assert np.linalg.norm(out_t[0].numpy() - ep.gt_p, axis=-1).mean() < 0.7 * e0


# --- the pipeline ----------------------------------------------------------------

PIPE_CFG = GlioConfig().replace(
    shapes=ShapeConfig(max_imu_per_interval=40, scan_points=256, map_points=2048),
    estimator=EstimatorConfig(local_map_width=6, sw_max_iter=4, sms_fusion_level=1,
                              search_range=3, ql2b=(1.0, 0, 0, 0), tl2b=(0, 0, 0)))
PIPE_EP = dict(n_keyframes=10, scan_points=256, seed=37, q_lb=(1, 0, 0, 0), t_lb=(0, 0, 0))


def _with_gnss(ep, simulate_gnss):
    ep.gnss = simulate_gnss(ep.gt_p, ep.kf_time, ANCHOR, STATION, psr_noise=0.5,
                            epoch_stride=2, seed=37)
    return ep


@pytest.fixture(scope="module")
def pipeline_runs(tmp_path_factory):
    d_j, d_t = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    f64 = functools.partial(JB.optimize_batch_sms1_imu, mixed=False)
    with unittest.mock.patch.object(JB, "optimize_batch_sms1_imu", f64):
        res_j = jax_run_pipeline(_with_gnss(jax_simulate_episode(**PIPE_EP), jax_simulate_gnss),
                                 PIPE_CFG,
                                 out_dir=str(d_j), run_batch=True, run_lc=False)
    ep_t = _with_gnss(simulate_episode(**PIPE_EP), simulate_gnss_epochs)
    res_t = run_pipeline(ep_t,
                         convert.config_from_glio(PIPE_CFG), out_dir=str(d_t),
                         run_batch=True, run_lc=False, device="cpu")
    return res_j, res_t, d_j, d_t, ep_t.gt_p


def test_pipeline_level1_matches_jax(pipeline_runs, pos_tol=4e-2):
    """Stage 1 agrees to 1e-4 m (the replay test's tolerance); stage 2 to
    10x JAX's own spread (module docstring)."""
    res_j, res_t, d_j, d_t, gt_p = pipeline_runs
    np.testing.assert_allclose(res_t.p_sw, res_j.p_sw, rtol=0, atol=1e-4)
    np.testing.assert_allclose(res_t.p_batch, np.asarray(res_j.p_batch), rtol=0, atol=pos_tol)
    np.testing.assert_allclose(res_t.q_batch, np.asarray(res_j.q_batch), rtol=0, atol=1e-3)
    got = np.loadtxt(d_t / "tc_batch_result.csv", delimiter=",", ndmin=2)
    want = np.loadtxt(d_j / "tc_batch_result.csv", delimiter=",", ndmin=2)
    assert got.shape == want.shape == (10, 12)
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    np.testing.assert_allclose(got[:, 9:12], want[:, 9:12], rtol=0, atol=pos_tol + 1e-8)
    assert np.isfinite(res_t.cov_batch).all() and np.isfinite(res_t.cov_batch_cal).all()
    assert np.linalg.norm(res_t.p_batch - gt_p, axis=-1).max() < 5.0
