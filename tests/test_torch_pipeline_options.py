"""Port parity: ``run_pipeline`` with loop closure, the map export and dense
frames, against ``glio_tpu.pipeline.run_pipeline`` on the same episodes.

Small shapes (256-point scans, map width 6-8, 4 LM iterations). Stage 1
is the replay both packages run, held to 1e-4 m as in
``tests/test_torch_pipeline.py``; each option's output inherits that
difference, so it is held to it too: map.pcd points (written to 1e-4 m) to
3e-4 m, dense frames and ``dense_path.csv`` to 1e-4 m, and the
loop-corrected chain to 1e-3 m (each ICP re-associates at the stage-1
poses and fits f32 planes: the JAX loop test's own ICP difference to the
port is 1e-4 m at these shapes, ``tests/test_torch_loop_closure.py``),
with the same number of loop edges.
"""

import dataclasses

import numpy as np
import pytest
import torch

from glio_tpu.config import EstimatorConfig, GlioConfig, ShapeConfig
from glio_tpu.data.simulator import simulate_episode as jax_simulate
from glio_tpu.eval.pointcloud import read_pcd as jax_read_pcd
from glio_tpu.pipeline import run_pipeline as jax_run_pipeline
from glio_tpu_torch import convert
from glio_tpu_torch.data.simulator import simulate_episode
from glio_tpu_torch.eval.pointcloud import read_pcd
from glio_tpu_torch.pipeline import run_pipeline

SMALL = GlioConfig().replace(
    shapes=ShapeConfig(max_imu_per_interval=40, scan_points=256, map_points=2048),
    estimator=EstimatorConfig(local_map_width=6, sw_max_iter=4))
M_PER_DEG = 111_320.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These runs are long chains of small torch ops: one intra-op thread
    is as fast alone, and keeps a parallel test run's workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(cfg, tmp_path, make, **kw):
    d_j, d_t = tmp_path / "jax", tmp_path / "port"
    res_j = jax_run_pipeline(make(jax_simulate), cfg, out_dir=str(d_j), **kw)
    res_t = run_pipeline(make(simulate_episode), convert.config_from_glio(cfg), out_dir=str(d_t),
                         device="cpu", **kw)
    return res_j, res_t, d_j, d_t


def test_save_pcd_matches_jax(tmp_path):
    cfg = SMALL.replace(estimator=dataclasses.replace(SMALL.estimator, save_pcd=True,
                                                      mapping_interval=2))
    res_j, res_t, d_j, d_t = _both(cfg, tmp_path,
                                   lambda sim: sim(n_keyframes=6, scan_points=256, seed=33),
                                   run_batch=False, run_lc=False)
    np.testing.assert_allclose(res_t.p_sw, res_j.p_sw, rtol=0, atol=1e-4)
    got, want = read_pcd(str(d_t / "map.pcd")), jax_read_pcd(str(d_j / "map.pcd"))
    assert got.shape == want.shape and got.shape[0] > 200
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-4)


def test_dense_frames_match_jax(tmp_path):
    res_j, res_t, d_j, d_t = _both(
        SMALL, tmp_path,
        lambda sim: sim(n_keyframes=8, scan_points=256, seed=19, dense_frames=3,
                        dense_noise=0.005),
        run_batch=False, run_lc=False)
    assert res_t.p_dense.shape == (7, 3, 3) and res_t.dense_valid.all()
    np.testing.assert_allclose(res_t.p_dense, np.asarray(res_j.p_dense), rtol=0, atol=1e-4)
    np.testing.assert_allclose(res_t.q_dense, np.asarray(res_j.q_dense), rtol=0, atol=1e-5)
    got = np.loadtxt(d_t / "dense_path.csv", delimiter=",", ndmin=2)
    want = np.loadtxt(d_j / "dense_path.csv", delimiter=",", ndmin=2)
    assert got.shape == want.shape == (21, 12)
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    np.testing.assert_allclose(got[:, 9:12], want[:, 9:12], rtol=0, atol=1e-4 + 1e-8)
    np.testing.assert_allclose(M_PER_DEG * got[:, 3:5], M_PER_DEG * want[:, 3:5], rtol=0,
                               atol=1e-4 + 2e-3)


def test_loop_closure_matches_jax(tmp_path):
    """A 36-keyframe circle (a lap in 12 s, radius ~9.5 m): keyframe 30
    revisits the start more than 5 s later."""
    cfg = GlioConfig().replace(
        shapes=ShapeConfig(max_imu_per_interval=40, scan_points=256, map_points=4096),
        estimator=EstimatorConfig(local_map_width=8, sw_max_iter=4, loop_closure_on=True,
                                  lc_search_radius=15.0, lc_time_thres=5.0, lc_map_width=8,
                                  lc_icp_thres=0.3))
    res_j, res_t, _, d_t = _both(
        cfg, tmp_path,
        lambda sim: sim(n_keyframes=36, scan_points=256, seed=17, circle_omega=2 * np.pi / 12.0),
        run_batch=False, run_lc=False)
    assert res_t.n_loop_edges == res_j.n_loop_edges >= 1
    np.testing.assert_allclose(res_t.p_sw, np.asarray(res_j.p_sw), rtol=0, atol=1e-3)
    np.testing.assert_allclose(res_t.q_sw, np.asarray(res_j.q_sw), rtol=0, atol=1e-4)
    assert (d_t / "tc_sw_result.csv").exists()
