"""Port parity: the sliding-window replay as a whole.

A 6-keyframe episode (seed 1) at a small shape (width 8, scan 256, map
2048, 4 LM iterations) goes through ``glio_tpu``'s ``make_replay`` (its main
path: f32 LM Jacobians, f32 preintegration covariance, refined-f32
Cholesky) and through ``glio_tpu_torch``'s estimator (plain f64 in their
place). Tolerances: positions 1e-4 m, quaternions 1e-5, cost rtol 1e-4 —
the JAX main path's mixed-precision solves differ from exact f64 at ~1e-5
relative (dense.py:77-84) — and n_lidar_factors equal at every step.

The resume check runs JAX for 3 keyframes, hands its carry to the port
through ``convert.carry_from_numpy`` and holds the port's next 3 keyframes
against JAX's own continuation.
"""

import jax
import numpy as np
import pytest
import torch

from glio_tpu.config import EstimatorConfig, GlioConfig, ShapeConfig
from glio_tpu.data.simulator import simulate_episode
from glio_tpu.models.sliding_window import make_replay as jax_make_replay
from glio_tpu_torch import convert
from glio_tpu_torch.gnss.dd import bind_epochs_to_keyframes
from glio_tpu_torch.models.sliding_window import (GnssKfData, KeyframeInput,
                                                  SlidingWindowEstimator,
                                                  make_replay)

CFG = GlioConfig().replace(
    shapes=ShapeConfig(max_imu_per_interval=40, scan_points=256, map_points=2048),
    estimator=EstimatorConfig(local_map_width=8, sw_max_iter=4))
TOL = {"p": 1e-4, "q": 1e-5}
COST_RTOL = 1e-4


@pytest.fixture(scope="module")
def episode():
    return simulate_episode(n_keyframes=6, scan_points=256, seed=1)


@pytest.fixture(scope="module")
def jax_replay():
    return jax_make_replay(CFG)[0]


def _port_inputs(ep, sl=slice(None)):
    bound = bind_epochs_to_keyframes(ep.gnss, ep.kf_time, 32)
    return convert.inputs_from_numpy(
        ep.imu_acc[sl], ep.imu_gyr[sl], ep.imu_dt[sl], ep.imu_valid[sl],
        ep.scan[sl], ep.scan_valid[sl], ep.kf_time[sl], device="cpu",
        gnss={k: v[sl] for k, v in bound.items()})


FIELDS = ("p", "q", "cost", "n_lidar_factors")


def _check(out_t, out_j, field):
    t, j = getattr(out_t, field).numpy(), np.asarray(getattr(out_j, field))
    if field in TOL:
        np.testing.assert_allclose(t, j, rtol=0, atol=TOL[field])
    elif field == "cost":
        np.testing.assert_allclose(t, j, rtol=COST_RTOL, atol=1e-9)
    else:
        np.testing.assert_array_equal(t, j)


@pytest.fixture(scope="module")
def outputs(episode, jax_replay):
    ep = episode
    out_j = jax_replay(ep.to_inputs(), ep.p0, ep.q0, ep.v0, ep.acc0, ep.gyr0)
    est = make_replay(convert.config_from_glio(CFG), "cpu")
    out_t = est(_port_inputs(ep), ep.p0, ep.q0, ep.v0, ep.acc0, ep.gyr0)
    return out_t, out_j


@pytest.mark.parametrize("field", FIELDS)
def test_replay_matches_jax(outputs, field):
    out_t, out_j = outputs
    _check(out_t, out_j, field)
    assert out_t.n_lidar_factors[-1] > 100          # the lidar rows engage


def test_resume_from_jax_carry(episode, jax_replay):
    ep = episode
    j_inputs = ep.to_inputs()
    carry0 = jax_replay.make_initial_carry(ep.p0, ep.q0, ep.v0, ep.acc0, ep.gyr0,
                                           inputs_template=j_inputs)
    carry3, _ = jax_replay.replay_from(carry0, jax.tree.map(lambda a: a[:3], j_inputs))
    _, out_j = jax_replay.replay_from(carry3, jax.tree.map(lambda a: a[3:], j_inputs))

    est = SlidingWindowEstimator(convert.config_from_glio(CFG), "cpu")
    tree = jax.tree.map(np.asarray, carry3)
    carry_t = convert.carry_from_numpy(tree, "cpu")
    _, out_t = est.replay_from(carry_t, _port_inputs(ep, slice(3, None)))
    for field in FIELDS:
        _check(out_t, out_j, field)

    back = convert.carry_to_numpy(carry_t)
    np.testing.assert_array_equal(back.base.map_world, tree.base.map_world)
    np.testing.assert_array_equal(back.base.window.q, tree.base.window.q)
    np.testing.assert_array_equal(back.imu_seed, tree.imu_seed)


def test_inputs_match_jax_episode(episode):
    """``Episode.to_inputs`` dtypes: scans f32, IMU data f64, masks bool;
    the bound GNSS fields (zeros here: no GNSS) field by field."""
    t = _port_inputs(episode)
    j = episode.to_inputs()
    for f in KeyframeInput._fields:
        a, b = getattr(t, f), getattr(j, f)
        pairs = (zip(a, b) if f == "gnss" else [(a, b)])
        for x, y in pairs:
            y = np.asarray(y)
            assert x.numpy().dtype == y.dtype, f
            np.testing.assert_array_equal(x.numpy(), y)
    assert type(t.gnss) is GnssKfData and len(t.gnss) == len(j.gnss)


@pytest.mark.parametrize("override", [
    {"estimator": EstimatorConfig(local_map_width=8, sw_max_iter=4,
                                  gnss_in_sliding_window=True, doppler_in_window=False)},
])
def test_unported_options_raise(override):
    """Once refused, ``gnss_in_sliding_window`` now runs: this episode with
    simulated GNSS at every keyframe, DD rows in the window, against JAX's
    replay within the module's tolerances."""
    from glio_tpu.data.simulator import simulate_gnss_epochs
    cfg = CFG.replace(**override)
    ep = simulate_episode(n_keyframes=6, scan_points=256, seed=1)
    ep.gnss = simulate_gnss_epochs(ep.gt_p, ep.kf_time, np.asarray(cfg.initialization.anc_ecef),
                                   np.asarray(cfg.initialization.station_ecef), psr_noise=0.3,
                                   epoch_stride=1, seed=1)
    out_j = jax_make_replay(cfg)[0](ep.to_inputs(), ep.p0, ep.q0, ep.v0, ep.acc0, ep.gyr0)
    est = SlidingWindowEstimator(convert.config_from_glio(cfg), "cpu")
    out_t = est(_port_inputs(ep), ep.p0, ep.q0, ep.v0, ep.acc0, ep.gyr0)
    for field in FIELDS:
        _check(out_t, out_j, field)
    assert bool(out_t.n_lidar_factors[-1] > 100)


def test_estimator_buffers_follow_device():
    est = SlidingWindowEstimator(convert.config_from_glio(CFG), "cpu")
    names = {n for n, _ in est.named_buffers()}
    assert names == {"gravity", "noise_cov", "q_lb", "t_lb", "anc_ecef", "station_ecef",
                     "lever_arm", "yaw_enu_local"}
    assert est.device == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
