"""Port parity: ``run_pipeline`` with batch level 1 (``sms_fusion_level=1``)
against JAX's on the 10-keyframe episode of the JAX package's level-1
pipeline test. The level-1 solves are ``tests/test_torch_sms1_solve.py``'s.

Tolerances. The 10-keyframe pipeline is far from converged and its level-1
result is sensitive to the association's near-ties: JAX's own f64 result
moves 4.1e-3 m when its stage-1 trajectory is nudged by -1e-9 m and
associated again (CPU, measured once), so the port is held to 10x that,
4e-2 m.
"""

import functools
import unittest.mock

import numpy as np
import pytest

from glio_tpu.config import EstimatorConfig, GlioConfig, ShapeConfig
from glio_tpu.data.simulator import simulate_episode as jax_simulate_episode
from glio_tpu.data.simulator import simulate_gnss_epochs as jax_simulate_gnss
from glio_tpu.models import batch as JB
from glio_tpu.pipeline import run_pipeline as jax_run_pipeline
from glio_tpu_torch import convert
from glio_tpu_torch.data.simulator import simulate_episode, simulate_gnss_epochs
from glio_tpu_torch.pipeline import run_pipeline
from test_torch_sms1_solve import ANCHOR, STATION

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
