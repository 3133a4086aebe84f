"""Port parity: ``run_pipeline`` (stages 1-3) and the probe entry point.

A 6-keyframe episode (seed 1) at the small shape of
``tests/test_torch_sliding_window.py`` (width 8, scan 256, map 2048, 4 LM
iterations) with simulated GNSS at every keyframe goes through
``glio_tpu.pipeline.run_pipeline`` and the port's, with ``run_lc`` at its
default (stage 3 runs: the episode has GNSS), and the CSVs they write are
compared. JAX's pipeline solves the batch in its mixed
precision; on so short a problem the batch is far from converged after 40
iterations and JAX's mixed and f64 results end 0.13 m apart, so the JAX
run here has its batch solve patched to ``mixed=False``, the port's
arithmetic (nothing in the JAX package changes). Tolerances: times equal;
positions 1e-4 m and angles 1e-3 degrees in both stages (the replay test's
1e-4 m and 1e-5 on the quaternion; the f64 batch carries a 1e-9 m nudge of
its input through as ~4e-9 m). ``lc_result.csv`` is held to the same
bounds: stage 3 starts from stage 1 and moves a difference there by about
one to one (``lc_gain_p_per_m`` in ``tests/data/pipeline_seed0.npz``).
"""

import dataclasses
import functools
import os
import subprocess
import sys
import unittest.mock

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
from glio_tpu_torch.ops import probe
from glio_tpu_torch.pipeline import run_pipeline
from glio_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = GlioConfig().replace(
    shapes=ShapeConfig(max_imu_per_interval=40, scan_points=256, map_points=2048),
    estimator=EstimatorConfig(local_map_width=8, sw_max_iter=4))
TCFG = convert.config_from_glio(CFG)
ANCHOR = np.asarray(CFG.initialization.anc_ecef)
STATION = np.asarray(CFG.initialization.station_ecef)
M_PER_DEG = 111_320.0


def _port_episode():
    ep = simulate_episode(n_keyframes=6, scan_points=256, seed=1)
    ep.gnss = simulate_gnss_epochs(ep.gt_p, ep.kf_time, ANCHOR, STATION,
                                   epoch_stride=1, seed=0)
    ep.anchor_ecef = ANCHOR
    return ep


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ep_j = jax_simulate_episode(n_keyframes=6, scan_points=256, seed=1)
    ep_j.gnss = jax_simulate_gnss(ep_j.gt_p, ep_j.kf_time, ANCHOR, STATION,
                                  epoch_stride=1, seed=0)
    ep_j.anchor_ecef = ANCHOR
    d_j = tmp_path_factory.mktemp("jax")
    d_t = tmp_path_factory.mktemp("port")
    with unittest.mock.patch.object(JB, "optimize_batch",
                                    functools.partial(JB.optimize_batch, mixed=False)):
        res_j = jax_run_pipeline(ep_j, CFG, out_dir=str(d_j))
    res_t = run_pipeline(_port_episode(), TCFG, out_dir=str(d_t), device="cpu")
    return res_j, res_t, d_j, d_t


def _rows(path):
    return np.loadtxt(path, delimiter=",", ndmin=2)


@pytest.mark.parametrize("name", ["tc_sw_result.csv", "tc_batch_result.csv", "lc_result.csv"])
def test_result_csv_matches_jax(runs, name, pos_tol=1e-4, deg_tol=1e-3):
    _, _, d_j, d_t = runs
    got, want = _rows(d_t / name), _rows(d_j / name)
    assert got.shape == want.shape == (6, 12)
    np.testing.assert_array_equal(got[:, :3], want[:, :3])                # t, week, tow
    np.testing.assert_allclose(got[:, 9:12], want[:, 9:12], rtol=0, atol=pos_tol + 1e-8)
    np.testing.assert_allclose(got[:, 5], want[:, 5], rtol=0, atol=pos_tol + 1e-8)
    np.testing.assert_allclose(M_PER_DEG * got[:, 3:5], M_PER_DEG * want[:, 3:5],
                               rtol=0, atol=pos_tol + 2e-3)               # 1e-8 deg ~ 1 mm
    np.testing.assert_allclose(got[:, 6:9], want[:, 6:9], rtol=0, atol=deg_tol)


def test_batch_cov_csv_matches_jax(runs):
    """Header text equal (calibration skipped here: 5 epochs < 10); the
    stds to 1e-6 relative and the full marginals to 1e-5 relative (at
    trajectories 1e-7 m apart; the roll gauge is held only by the 1e-9
    jitter)."""
    res_j, res_t, d_j, d_t = runs
    text_t = (d_t / "tc_batch_cov.csv").read_text().splitlines()
    text_j = (d_j / "tc_batch_cov.csv").read_text().splitlines()
    assert text_t[:3] == text_j[:3]
    assert "SKIPPED" in text_t[1]
    got = np.loadtxt(d_t / "tc_batch_cov.csv", delimiter=",", skiprows=3)
    want = np.loadtxt(d_j / "tc_batch_cov.csv", delimiter=",", skiprows=3)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=1e-6)
    np.testing.assert_allclose(res_t.cov_batch, np.asarray(res_j.cov_batch),
                               rtol=1e-5, atol=1e-6 * np.abs(res_j.cov_batch).max())


def test_pipeline_result_fields(runs):
    res_j, res_t, _, _ = runs
    np.testing.assert_allclose(res_t.p_sw, res_j.p_sw, rtol=0, atol=1e-4)
    np.testing.assert_allclose(res_t.p_batch, res_j.p_batch, rtol=0, atol=1e-4)
    np.testing.assert_allclose(res_t.p_lc, res_j.p_lc, rtol=0, atol=1e-4)
    np.testing.assert_allclose(res_t.q_lc, res_j.q_lc, rtol=0, atol=1e-5)
    assert res_t.n_lidar_factors.shape == (6,) and res_t.n_lidar_factors[-1] > 100
    assert res_t.p_dense is None and res_t.n_loop_edges == 0


def test_stage_one_only():
    res = run_pipeline(_port_episode(), TCFG, run_batch=False, run_lc=False, device="cpu",
                       sw_chunk=4)
    assert res.p_batch is None and res.p_lc is None and res.p_sw.shape == (6, 3)


def _with(cfg, **kw):
    return dataclasses.replace(cfg, estimator=dataclasses.replace(cfg.estimator, **kw))


@pytest.mark.parametrize("case", ["doppler_in_batch"])
def test_unported_options_raise_before_running(case, runs):
    """``doppler_in_batch``, once refused before anything ran, now runs
    through ``run_pipeline``: its stage-2 batch with Doppler rows against
    JAX's ``run_pipeline`` with Doppler rows (batch in f64) on the same
    episode, at this module's tolerance, and the Doppler rows move it."""
    res_plain = runs[0]
    cfg_j = CFG.replace(estimator=dataclasses.replace(CFG.estimator, doppler_in_batch=True))
    ep_j = jax_simulate_episode(n_keyframes=6, scan_points=256, seed=1)
    ep_j.gnss = jax_simulate_gnss(ep_j.gt_p, ep_j.kf_time, ANCHOR, STATION,
                                  epoch_stride=1, seed=0)
    ep_j.anchor_ecef = ANCHOR
    with unittest.mock.patch.object(JB, "optimize_batch",
                                    functools.partial(JB.optimize_batch, mixed=False)):
        res_j = jax_run_pipeline(ep_j, cfg_j, run_lc=False)
    res = run_pipeline(_port_episode(), _with(TCFG, doppler_in_batch=True), run_lc=False,
                       device="cpu")
    np.testing.assert_allclose(res.p_sw, res_j.p_sw, rtol=0, atol=1e-4)
    np.testing.assert_allclose(res.p_batch, res_j.p_batch, rtol=0, atol=1e-4)
    assert np.abs(np.asarray(res_j.p_batch) - np.asarray(res_plain.p_batch)).max() > 1e-3
    assert res.p_lc is None and np.isfinite(res.cov_batch).all()


def test_probe_exits_1_without_cuda():
    res = subprocess.run([sys.executable, "-m", "glio_tpu_torch.ops.probe"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 1
    assert "CUDA-DEAD" in res.stdout


def test_copy_on_cpu_is_the_plain_version():
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
    before = profiling.tallies().get("copy.launches", 0)
    y = probe.copy(x)
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    assert profiling.tallies().get("copy.launches", 0) == before   # no kernel launched
    with pytest.raises(TypeError):
        probe.copy(x.double())
    with pytest.raises(ValueError):
        probe.copy(x.t())
