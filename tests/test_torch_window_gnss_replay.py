"""Port parity: the GNSS-window replays (``gnss_in_sliding_window``, with and
without ``doppler_in_window``) against the JAX package, on the scenarios and
tolerances of ``tests/test_torch_window_gnss.py``.

The replays run the JAX package's GNSS-window scenarios
(``tests/test_sliding_window_e2e.py``: scan 512, map 4096, width 8, 8 LM
iterations, ``simulate_gnss_epochs(psr_noise=0.3, epoch_stride=1)``), cut to
12 keyframes, through ``glio_tpu``'s ``make_replay`` (its main path: f32 LM
Jacobians, refined-f32 Cholesky) and the port's estimator (plain f64).
Tolerances: positions 1e-4 m, quaternions 1e-5 and the receiver clock
drift 1e-5 m/s, or 10x JAX's own spread under a ±1e-9 m nudge of p0 where
that is larger: with the Doppler rows the LM's accept/reject turns a 1e-9 m
nudge into 1.4e-3 m by keyframe 12, and the port lands as far from JAX as
JAX's own nudged runs do. n_lidar_factors equal at every step.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from glio_tpu.models.sliding_window import make_replay as jax_make_replay
from glio_tpu_torch import convert
from glio_tpu_torch.models import sliding_window as sw
from test_torch_window_gnss import N_KF, TOL, _cfg, _episodes

SPREAD_FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                              "window_gnss_spread_seed21.npz")


@pytest.fixture(scope="module", params=[False, True], ids=["dd", "dd_doppler"])
def replays(request):
    doppler = request.param
    cfg = _cfg(doppler)
    seed = 21 if doppler else 12
    ep_j, ep_t = _episodes(seed)
    out_j = jax_make_replay(cfg)[0](ep_j.to_inputs(), ep_j.p0, ep_j.q0, ep_j.v0, ep_j.acc0,
                                    ep_j.gyr0)
    # JAX's own spread under a ±1e-9 m nudge of p0, per keyframe and field,
    # from scripts/make_torch_gnss_fixture.py --only window_test (the DD-only
    # replay stays well inside the fixed tolerances).
    spread = {f: np.zeros(np.asarray(getattr(out_j, f)).shape[0]) for f in TOL}
    if doppler:
        fx = np.load(SPREAD_FIXTURE)
        assert json.loads(str(fx["scenario_json"])) == dict(
            n_keyframes=N_KF, scan_points=512, seed=seed, psr_noise=0.3)
        assert json.loads(str(fx["config_json"])) == json.loads(
            json.dumps(dataclasses.asdict(cfg)))
        spread = {f: fx[f"spread_{f}"] for f in TOL}
    est = sw.make_replay(convert.config_from_glio(cfg), "cpu")
    out_t = est(ep_t.to_inputs("cpu"), ep_t.p0, ep_t.q0, ep_t.v0, ep_t.acc0, ep_t.gyr0)
    return doppler, ep_t, out_j, out_t, spread


@pytest.mark.parametrize("field", ["p", "q", "ddt", "n_lidar_factors"])
def test_gnss_window_replay_matches_jax(replays, field):
    doppler, ep, out_j, out_t, spread = replays
    got, want = getattr(out_t, field).numpy(), np.asarray(getattr(out_j, field))
    if field in TOL:
        tol = np.maximum(TOL[field], 10.0 * spread[field])
        d = np.abs(got - want).reshape(got.shape[0], -1).max(-1)
        assert (d <= tol).all(), (d, tol)
    else:
        np.testing.assert_array_equal(got, want)
    if field == "ddt":
        # The Doppler path estimates the simulated drift (1e-3·c·1e-8 ≈
        # 3e-3 m/s) to the JAX package's own bound; without it the ring
        # stays at zero.
        assert (np.abs(got[-4:] - 2.998e-3) < 0.1).all() if doppler else (got == 0).all()
    if field == "p":
        assert np.linalg.norm(got - ep.gt_p, axis=-1).max() < 2.0
