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
Positions are held within 10x JAX's own spread under that nudge. The
write-back of the fused poses is ``tests/test_torch_backend_fusion_write_back.py``'s.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from glio_tpu_torch import pipeline
from glio_tpu_torch.config import EstimatorConfig, GlioConfig, ShapeConfig
from glio_tpu_torch.data.simulator import simulate_episode, simulate_gnss_epochs
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


class _Arms(dict):
    """Each arm's run, made when a test first asks for it, so that the two
    replays count against two tests' time limits, not one."""

    def __init__(self, run):
        super().__init__()
        self.run = run

    def __missing__(self, tag):
        self[tag] = self.run(tag)
        return self[tag]


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

    def run(tag):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            p, q = pipeline.replay_with_backend_fusion(
                ARMS[tag], ep, ep.to_inputs("cpu"), anchor, 0.0, station, every=sc["every"],
                fusion_span=sc["fusion_span"], debug=True)
        return p, q, buf.getvalue().splitlines()
    return fx, ep, _Arms(run)


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
