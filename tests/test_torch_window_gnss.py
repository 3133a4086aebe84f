"""Port parity: GNSS in the sliding window (``gnss_in_sliding_window``, with
and without ``doppler_in_window``): the epoch binding, the three GNSS factor
evaluators, the replay, the backend-fusion reset of the clock-drift ring and
``Episode.save`` / ``load``.

The replays run the JAX package's GNSS-window scenarios
(``tests/test_sliding_window_e2e.py``: scan 512, map 4096, width 8, 8 LM
iterations, ``simulate_gnss_epochs(psr_noise=0.3, epoch_stride=1)``), cut to
12 keyframes, through ``glio_tpu``'s ``make_replay`` (its main path: f32 LM
Jacobians, refined-f32 Cholesky) and the port's estimator (plain f64).
Tolerances: positions 1e-4 m, quaternions 1e-5 and the receiver clock
drift 1e-5 m/s (the window without GNSS is held to the first two,
``tests/test_torch_sliding_window.py``), or 10x JAX's own spread under a
±1e-9 m nudge of p0 where that is larger: with the Doppler rows the LM's
accept/reject turns a 1e-9 m nudge into 1.4e-3 m by keyframe 12, and the
port lands as far from JAX as JAX's own nudged runs do. n_lidar_factors
equal at every step. The binding is host numpy on both sides: equal bit for
bit. The factors: 1e-9 of their largest value (f64 sums in another order).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glio_tpu.config import EstimatorConfig, GlioConfig, ShapeConfig
from glio_tpu.data.simulator import simulate_episode as jax_simulate
from glio_tpu.data.simulator import simulate_gnss_epochs as jax_gnss
from glio_tpu.factors import gnss as j_fac
from glio_tpu.gnss import dd as j_dd
from glio_tpu.models.sliding_window import make_replay as jax_make_replay
from glio_tpu_torch import convert, pipeline
from glio_tpu_torch.data.episode import Episode
from glio_tpu_torch.data.simulator import simulate_episode, simulate_gnss_epochs
from glio_tpu_torch.factors import gnss as t_fac
from glio_tpu_torch.gnss import dd as t_dd
from glio_tpu_torch.models import sliding_window as sw

SHAPES = ShapeConfig(max_imu_per_interval=40, scan_points=512, map_points=4096)
ANCHOR = np.asarray(GlioConfig().initialization.anc_ecef)
STATION = np.asarray(GlioConfig().initialization.station_ecef)
N_KF = 12
TOL = {"p": 1e-4, "q": 1e-5, "ddt": 1e-5}
SPREAD_FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                              "window_gnss_spread_seed21.npz")


def _cfg(doppler):
    return GlioConfig().replace(shapes=SHAPES, estimator=EstimatorConfig(
        local_map_width=8, sw_max_iter=8, gnss_in_sliding_window=True,
        doppler_in_window=doppler))


def _episodes(seed, n=N_KF, scan=512):
    ep_j = jax_simulate(n_keyframes=n, scan_points=scan, seed=seed)
    ep_j.gnss = jax_gnss(ep_j.gt_p, ep_j.kf_time, ANCHOR, STATION, psr_noise=0.3,
                         epoch_stride=1, seed=seed)
    ep_t = simulate_episode(n_keyframes=n, scan_points=scan, seed=seed)
    ep_t.gnss = simulate_gnss_epochs(ep_t.gt_p, ep_t.kf_time, ANCHOR, STATION, psr_noise=0.3,
                                     epoch_stride=1, seed=seed)
    return ep_j, ep_t


def test_bind_epochs_matches_jax():
    """Every interval's latest epoch, including one exactly at a keyframe
    time (it binds to the interval it closes) and intervals without one."""
    _, ep = _episodes(4, n=10, scan=64)
    g = ep.gnss
    g.time = g.time.copy()
    g.time[3] = ep.kf_time[4]                    # exactly at keyframe 4
    g.time[6] = ep.kf_time[6] + 0.5              # past the last keyframe it could close
    kf = ep.kf_time
    out_t = t_dd.bind_epochs_to_keyframes(g, kf, 32)
    out_j = j_dd.bind_epochs_to_keyframes(g, kf, 32)
    assert sorted(out_t) == sorted(out_j)
    for k in out_t:
        assert out_t[k].dtype == out_j[k].dtype, k
        np.testing.assert_array_equal(out_t[k], out_j[k], err_msg=k)
    assert out_t["gnss_valid"][4] and out_t["gnss_ratio"][4] == 0.0
    assert not out_t["gnss_valid"][0]
    empty = t_dd.bind_epochs_to_keyframes(None, kf, 32)
    assert not empty["gnss_valid"].any() and (empty["gnss_master"] == -1).all()


@pytest.fixture(scope="module")
def bound():
    _, ep = _episodes(5, n=6, scan=64)
    b = t_dd.bind_epochs_to_keyframes(ep.gnss, ep.kf_time, 32)
    rng = np.random.default_rng(1)
    p = ep.gt_p + rng.normal(0, 0.5, ep.gt_p.shape)
    v = ep.gt_v + rng.normal(0, 0.2, ep.gt_v.shape)
    return b, p, v


def _fac_args(b, k):
    return dict(sat_pos=b["gnss_sat_pos"][k], psr_rov=b["gnss_psr_rov"][k],
                psr_sta=b["gnss_psr_sta"][k], valid=b["gnss_sv_valid"][k],
                system=b["gnss_system"][k], master=b["gnss_master"][k],
                whiten=b["gnss_whiten"][k])


def test_dd_psr_residual_matches_jax(bound):
    b, p, _ = bound
    lever = np.array([0.1, -0.2, 0.3])
    T = p.shape[0]
    got = t_fac.dd_psr_residual(
        torch.tensor(p[:-1]), torch.tensor(p[1:]), torch.tensor(b["gnss_ratio"][1:]),
        torch.tensor(ANCHOR), 0.2, torch.tensor(STATION),
        *(torch.tensor(np.stack([_fac_args(b, k)[f] for k in range(1, T)]))
          for f in ("sat_pos", "psr_rov", "psr_sta", "valid", "system", "master", "whiten")),
        threshold=10.0, lever_arm=torch.tensor(lever)).numpy()
    for k in range(1, T):
        a = _fac_args(b, k)
        want = np.asarray(j_fac.dd_psr_residual(
            jnp.asarray(p[k - 1]), jnp.asarray(p[k]), b["gnss_ratio"][k], jnp.asarray(ANCHOR),
            jnp.asarray(0.2), jnp.asarray(STATION), *(jnp.asarray(a[f]) for f in (
                "sat_pos", "psr_rov", "psr_sta", "valid", "system", "master", "whiten")),
            threshold=10.0, lever_arm=jnp.asarray(lever)))
        np.testing.assert_allclose(got[k - 1], want, rtol=0, atol=1e-9 * np.abs(want).max())
    assert np.abs(got).max() > 0.1


def test_doppler_and_clock_drift_residuals_match_jax(bound):
    b, p, v = bound
    T = p.shape[0]
    ddt = np.linspace(2.5, 3.5, T - 1)
    var = np.maximum(b["gnss_dopp_std"][1:], 1e-3)
    valid = b["gnss_dopp_valid"][1:] & b["gnss_sv_valid"][1:]
    got = t_fac.doppler_residual(
        torch.tensor(p[:-1]), torch.tensor(v[:-1]), torch.tensor(p[1:]), torch.tensor(v[1:]),
        torch.tensor(b["gnss_ratio"][1:]), torch.tensor(ddt), torch.tensor(ANCHOR), 0.0,
        torch.tensor(b["gnss_sat_pos"][1:]), torch.tensor(b["gnss_sat_vel"][1:]),
        torch.tensor(b["gnss_sat_ddt"][1:]), torch.tensor(b["gnss_dopp"][1:]),
        torch.tensor(valid), torch.tensor(var)).numpy()
    for k in range(1, T):
        want = np.asarray(j_fac.doppler_residual(
            jnp.asarray(p[k - 1]), jnp.asarray(v[k - 1]), jnp.asarray(p[k]), jnp.asarray(v[k]),
            b["gnss_ratio"][k], ddt[k - 1], jnp.asarray(ANCHOR), jnp.asarray(0.0),
            *(jnp.asarray(b[f][k]) for f in ("gnss_sat_pos", "gnss_sat_vel", "gnss_sat_ddt",
                                             "gnss_dopp")),
            jnp.asarray(valid[k - 1]), jnp.asarray(var[k - 1])))
        np.testing.assert_allclose(got[k - 1], want, rtol=0, atol=1e-9 * np.abs(want).max())
    mask = np.array([True, False, True, True])
    np.testing.assert_array_equal(
        t_fac.clock_drift_residual(torch.tensor(ddt), torch.tensor(mask)).numpy(),
        np.asarray(j_fac.clock_drift_residual(jnp.asarray(ddt), jnp.asarray(mask))))


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


def test_gnss_rows_change_the_solution():
    """The GNSS rows engage: the same episode without them solves elsewhere,
    and the Doppler rows move it again."""
    _, ep = _episodes(12, n=4, scan=128)
    shapes = ShapeConfig(max_imu_per_interval=40, scan_points=128, map_points=1024)
    outs = []
    for gnss, dopp in ((False, False), (True, False), (True, True)):
        cfg = convert.config_from_glio(GlioConfig().replace(shapes=shapes, estimator=EstimatorConfig(
            local_map_width=8, sw_max_iter=2, gnss_in_sliding_window=gnss,
            doppler_in_window=dopp)))
        outs.append(sw.make_replay(cfg, "cpu")(ep.to_inputs("cpu"), ep.p0, ep.q0, ep.v0,
                                               ep.acc0, ep.gyr0).p)
    assert not torch.equal(outs[0][1:], outs[1][1:])
    assert not torch.equal(outs[1][1:], outs[2][1:])


def test_resume_from_jax_gnss_carry():
    """JAX's carry after 4 keyframes (its GNSS ring and clock-drift ring
    included) through ``convert.carry_from_numpy``; the port's next 4
    keyframes against JAX's continuation."""
    cfg = _cfg(True)
    ep_j, ep_t = _episodes(27, n=8)
    replay = jax_make_replay(cfg)[0]
    inputs = ep_j.to_inputs()
    carry0 = replay.make_initial_carry(ep_j.p0, ep_j.q0, ep_j.v0, ep_j.acc0, ep_j.gyr0,
                                       inputs_template=inputs)
    carry4, _ = replay.replay_from(carry0, jax.tree.map(lambda a: a[:4], inputs))
    _, out_j = replay.replay_from(carry4, jax.tree.map(lambda a: a[4:], inputs))
    est = sw.make_replay(convert.config_from_glio(cfg), "cpu")
    tree = jax.tree.map(np.asarray, carry4)
    carry_t = convert.carry_from_numpy(tree, "cpu")
    np.testing.assert_array_equal(carry_t.gnss_win.whiten.numpy(), tree.gnss_win.whiten)
    assert carry_t.gnss_win.master.dtype == torch.int32
    _, out_t = est.replay_from(carry_t, sw.index_inputs(ep_t.to_inputs("cpu"), slice(4, None)))
    for f in ("p", "ddt"):
        np.testing.assert_allclose(getattr(out_t, f).numpy(), np.asarray(getattr(out_j, f)),
                                   rtol=0, atol=TOL[f])
    back = convert.carry_to_numpy(carry_t)
    np.testing.assert_array_equal(back.ddt, tree.ddt)
    state = convert.state_ddt_from_numpy(
        sw.WindowStateDdt(tree.base.window, tree.ddt), "cpu")
    moved = sw.retract_ddt(state, torch.arange(5 * 15 + 5, dtype=torch.float64) * 1e-3)
    np.testing.assert_allclose(moved.ddt.numpy(), tree.ddt + np.arange(75, 80) * 1e-3)
    kf = convert.gnss_kf_from_numpy(jax.tree.map(lambda a: np.asarray(a)[0], inputs.gnss), "cpu")
    assert kf.whiten.shape == (4, 32, 32)


def test_backend_fusion_reset_zeroes_ddt(monkeypatch):
    """A guarded reset in ``replay_with_backend_fusion`` restarts the
    window's receiver clock drifts from zero: the fused tail is displaced by
    50 m, so the window's drift trips the gate at the fusion after keyframe
    16, and the carry that enters the next keyframes has ddt = 0."""
    cfg = convert.config_from_glio(GlioConfig().replace(
        shapes=ShapeConfig(max_imu_per_interval=40, scan_points=256, map_points=2048),
        estimator=EstimatorConfig(local_map_width=8, sw_max_iter=4, gnss_in_sliding_window=True,
                                  doppler_in_window=True)))
    _, ep = _episodes(21, n=24, scan=256)
    entering = []
    orig = sw.SlidingWindowEstimator.replay_from

    def recording(self, carry, inputs):
        entering.append(carry.ddt.clone())
        return orig(self, carry, inputs)

    def displaced(cfg_, ep_, p_hist, q_hist, s0, t, *a, **kw):
        return p_hist[s0:t] + np.array([50.0, 0.0, 0.0]), q_hist[s0:t]

    monkeypatch.setattr(sw.SlidingWindowEstimator, "replay_from", recording)
    monkeypatch.setattr(pipeline, "_fusion_window", displaced)
    p, _ = pipeline.replay_with_backend_fusion(cfg, ep, ep.to_inputs("cpu"), ANCHOR, 0.0,
                                               STATION, every=8)
    assert len(entering) == 3 and p.shape == (24, 3)
    assert (entering[1] != 0).all()                  # estimated before the reset
    assert (entering[2] == 0).all()                  # zeroed by it


def test_episode_save_load_roundtrip(tmp_path):
    _, ep = _episodes(6, n=5, scan=64)
    ep.anchor_ecef = ANCHOR
    ep.yaw_enu_local = 0.0
    path = str(tmp_path / "ep.npz")
    ep.save(path)
    back = Episode.load(path)
    for f in dataclasses.fields(Episode):
        a, b = getattr(back, f.name), getattr(ep, f.name)
        if f.name == "gnss":
            for g in dataclasses.fields(a):
                np.testing.assert_array_equal(getattr(a, g.name), getattr(b, g.name))
        elif b is None:
            assert a is None, f.name
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert back.yaw_enu_local == 0.0
    # The JAX package reads the port's file, and the port reads JAX's.
    from glio_tpu.data.episode import Episode as JaxEpisode
    j = JaxEpisode.load(path)
    np.testing.assert_array_equal(j.gnss.psr_rov, ep.gnss.psr_rov)
    j.save(str(tmp_path / "j.npz"))
    np.testing.assert_array_equal(Episode.load(str(tmp_path / "j.npz")).scan, ep.scan)
