"""Port parity: backend fusion (``pipeline.replay_with_backend_fusion``).

The divergence scenario of ``tests/test_pipeline_aux.py::
test_divergence_recovery_via_config_gates`` (48 keyframes of 256 points,
IMU specific force +1.5 m/s² on keyframes 12-21, LiDAR blinded on 12-25,
GNSS at every keyframe, ``every=8``, ``fusion_span=48``) runs through the
port on the CPU in both arms: the gates at 20 m / 8 m, and disabled. The
JAX side is ``tests/data/backend_fusion_small_seed21.npz``
(``scripts/make_torch_stage3_fixture.py --only fusion_small``; its batch
solves in f64, the port's arithmetic): its ``debug`` lines give the reset
decisions, which the port must repeat where JAX's own are stable under a
±1e-9 m nudge of p0, and both arms are held to the JAX test's criteria.
Positions are held within 10x JAX's own spread under that nudge.

The reference quirk is copied, not fixed: the write-back of the fused
poses reaches ``map_p`` / ``map_q`` only, and the step associates against
the cached ``map_world`` clouds.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from glio_tpu_torch import pipeline
from glio_tpu_torch.config import EstimatorConfig, GlioConfig, ShapeConfig
from glio_tpu_torch.data.simulator import simulate_episode, simulate_gnss_epochs
from glio_tpu_torch.models.sliding_window import index_inputs
from glio_tpu_torch.testing import divergence_episode, reset_decisions

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "backend_fusion_small_seed21.npz")


def _cfg(drift_thr, fix_gate):
    return GlioConfig().replace(
        shapes=ShapeConfig(max_imu_per_interval=40, scan_points=256, map_points=4096),
        estimator=EstimatorConfig(local_map_width=8, sw_max_iter=8,
                                  reset_drift_threshold=drift_thr,
                                  reset_fix_disagree=fix_gate))


ARMS = {"gated": _cfg(20.0, 8.0), "off": _cfg(1e9, 1e9)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These runs are long chains of small torch ops: one intra-op thread
    is as fast alone, and keeps a parallel test run's workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    fx = np.load(FIXTURE)
    sc = json.loads(str(fx["scenario_json"]))
    ep = divergence_episode(sc, simulate_episode)
    cfg = ARMS["gated"]
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    ep.gnss = simulate_gnss_epochs(ep.gt_p, ep.kf_time, anchor, station, psr_noise=0.5,
                                   epoch_stride=sc["epoch_stride"], seed=sc["seed"])
    out = {}
    for tag, arm in ARMS.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            p, q = pipeline.replay_with_backend_fusion(
                arm, ep, ep.to_inputs("cpu"), anchor, 0.0, station, every=sc["every"],
                fusion_span=sc["fusion_span"], debug=True)
        out[tag] = (p, q, buf.getvalue().splitlines())
    return fx, ep, out


def test_fixture_arms_are_the_tests_configs():
    fx = np.load(FIXTURE)
    import dataclasses
    for tag, arm in ARMS.items():
        assert json.loads(str(fx[f"config_json_{tag}"])) == json.loads(
            json.dumps(dataclasses.asdict(arm)))
    np.testing.assert_array_equal(
        fx["gt_p"], divergence_episode(json.loads(str(fx["scenario_json"])), simulate_episode).gt_p)


@pytest.mark.parametrize("arm", ["gated", "off"])
def test_reset_decisions_match_jax(runs, arm):
    fx, _, out = runs
    want = reset_decisions(json.loads(str(fx[f"lines_{arm}"])))
    got = reset_decisions(out[arm][2])
    if arm == "off":
        assert got == want == []
    else:
        assert want, "the JAX fixture must show a reset"
        if bool(fx["decisions_stable"]):
            assert got == want
    # The debug lines carry the same fields at the same keyframes.
    fields = lambda lines: [line.split(" drift=")[0] for line in lines if "drift=" in line]
    assert fields(out[arm][2]) == fields(json.loads(str(fx[f"lines_{arm}"])))


def test_divergence_criteria_of_the_jax_test(runs):
    """``test_divergence_recovery_via_config_gates``'s phase-robust criteria."""
    _, ep, out = runs
    err_rec = np.linalg.norm(out["gated"][0] - ep.gt_p, axis=-1)
    err_off = np.linalg.norm(out["off"][0] - ep.gt_p, axis=-1)
    tail_rec, tail_off = err_rec[-8:].mean(), err_off[-8:].mean()
    assert tail_off > 15.0, tail_off
    assert err_off[-8:].min() > 15.0, err_off[-8:]
    assert err_rec[-8:].min() < 6.0, err_rec[-8:]
    assert tail_rec < 0.5 * tail_off, (tail_rec, tail_off)


def test_gated_positions_within_jax_spread(runs):
    fx, _, out = runs
    tol = 10.0 * float(fx["nudge_dp"])
    assert np.isfinite(out["gated"][0]).all() and np.isfinite(out["gated"][1]).all()
    assert np.abs(out["gated"][0] - fx["p_gated"]).max() <= tol


def test_map_write_back_reaches_map_p_q_only(monkeypatch):
    """The fused poses land in ``map_p`` / ``map_q`` of the frames that left
    the window, ``map_world`` is untouched, and a step does not read
    ``map_p`` / ``map_q``: as in the JAX package."""
    cfg = _cfg(1e9, 1e9)
    ep = simulate_episode(n_keyframes=20, scan_points=256, seed=21)
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    ep.gnss = simulate_gnss_epochs(ep.gt_p, ep.kf_time, anchor, station, psr_noise=0.5,
                                   epoch_stride=1, seed=21)
    seen = []
    make = pipeline.make_replay

    def recording(cfg_, device):
        est = make(cfg_, device)
        replay_from = est.replay_from

        def record(carry, inputs):
            out = replay_from(carry, inputs)
            seen.append((carry, out[0]))
            return out
        est.replay_from = record
        seen.append(est)
        return est

    monkeypatch.setattr(pipeline, "make_replay", recording)
    pipeline.replay_with_backend_fusion(cfg, ep, ep.to_inputs("cpu"), anchor, 0.0, station,
                                        every=8, fusion_span=16)
    est, (c0_in, c0_out), (c1_in, c1_out), (c2_in, _) = seen
    K, M = cfg.estimator.slide_window_width, cfg.estimator.local_map_width
    # The fusion after 16 keyframes corrected frames 16 − M .. 16 − K − 1.
    b_out, b_in = c1_out.base, c2_in.base
    assert torch.equal(b_in.map_world, b_out.map_world)
    moved = [i % M for i in range(16 - M, 16 - K)]
    assert not torch.equal(b_in.map_p[moved], b_out.map_p[moved])
    kept = [s for s in range(M) if s not in moved]
    assert torch.equal(b_in.map_p[kept], b_out.map_p[kept])
    # A step from either carry gives the same keyframe.
    inp = index_inputs(ep.to_inputs("cpu"), 16)
    _, o1 = est.step(c2_in, inp)
    _, o2 = est.step(c2_in._replace(base=c2_in.base._replace(map_p=b_out.map_p,
                                                            map_q=b_out.map_q)), inp)
    assert torch.equal(o1.p, o2.p) and torch.equal(o1.q, o2.q)
