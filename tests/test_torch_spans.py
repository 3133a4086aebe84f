"""The span recorder (``glio_tpu_torch.utils.profiling.span``), the kNN work
counter, and the spans of the window step and the batch solve, on the CPU.

Off, a span is one shared no-op; on, records nest with parent and unit ids
on the profiler's clock. One small CPU ``step`` records the seven window
spans in order, and each small batch solve (level 0, the zenith bias, level
1's pose-only and 15-dof solves) its stages and each LM iteration's three
parts.
"""

import numpy as np
import pytest
import torch

from glio_tpu_torch.config import GlioConfig, load_config
from glio_tpu_torch.data.simulator import (drifted_trajectory, simulate_episode,
                                           simulate_gnss_epochs)
from glio_tpu_torch.models import batch as batch_mod
from glio_tpu_torch.models import sliding_window as sw
from glio_tpu_torch.ops import knn as knn_mod
from glio_tpu_torch.utils import profiling

WINDOW_SPANS = ["window.step", "window.preintegrate", "window.voxel_map", "window.associate",
                "window.lm", "window.marginalize", "window.map_ring"]


@pytest.fixture(autouse=True)
def _recorder_off():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _clock(monkeypatch, step=10):
    """A perf_counter_ns that advances ``step`` ns a reading; the offset 0."""
    ticks = iter(range(0, 10**9, step))
    monkeypatch.setattr(profiling.time, "perf_counter_ns", lambda: next(ticks))
    monkeypatch.setattr(profiling.time, "time_ns", lambda: 0)


def test_off_is_one_shared_no_op(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock while recording was off")
    monkeypatch.setattr(profiling.time, "perf_counter_ns", no_clock)
    a, b = profiling.span("a"), profiling.span("b")
    assert a is b
    with a:
        with b:
            pass
    assert not profiling.recording()
    assert profiling.records() == []


def test_nesting_parents_units_and_self_time(monkeypatch):
    _clock(monkeypatch)
    profiling.enable()
    with profiling.span("root"):              # start 10
        with profiling.span("a"):             # 20
            with profiling.span("a.1"):       # 30 .. 40
                pass
        with profiling.span("b"):             # 60 .. 70, a ends 50
            pass
    with profiling.span("root"):              # 90 .. 120
        with profiling.span("a"):             # 100 .. 110
            pass
    profiling.disable()
    rec = profiling.records()
    assert [(r.name, r.id, r.parent, r.unit) for r in rec] == [
        ("root", 0, -1, 0), ("a", 1, 0, 0), ("a.1", 2, 1, 0), ("b", 3, 0, 0),
        ("root", 4, -1, 1), ("a", 5, 4, 1)]
    assert [(r.start_ns, r.end_ns) for r in rec] == [
        (10, 80), (20, 50), (30, 40), (60, 70), (90, 120), (100, 110)]
    assert profiling.self_ns(rec) == [70 - 30 - 10, 30 - 10, 10, 10, 30 - 10, 10]
    profiling.reset()
    assert profiling.records() == []
    profiling.enable()
    with profiling.span("again"):
        pass
    assert [(r.id, r.unit) for r in profiling.records()] == [(0, 0)]


def test_a_span_closes_on_an_exception():
    profiling.enable()
    with pytest.raises(ValueError):
        with profiling.span("outer"):
            with profiling.span("inner"):
                raise ValueError
    with profiling.span("next"):
        pass
    rec = profiling.records()
    assert [(r.name, r.parent) for r in rec] == [("outer", -1), ("inner", 0), ("next", -1)]
    assert all(r.end_ns >= r.start_ns > 0 for r in rec)


def test_spans_lie_on_the_profilers_clock():
    import time
    profiling.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            time.sleep(0.002)
            with torch.profiler.record_function("inner"):
                time.sleep(0.001)
            time.sleep(0.002)
    s = profiling.records()[0]
    inner = [e for e in prof.profiler.kineto_results.events() if e.name() == "inner"]
    assert len(inner) == 1
    e = inner[0]
    assert s.start_ns < e.start_ns() < e.start_ns() + e.duration_ns() < s.end_ns


def _knn_inputs(seed, q=40, n=300):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(q, 3, generator=g), torch.rand(q, generator=g) < 0.7,
            torch.rand(n, 3, generator=g), torch.rand(n, generator=g) < 0.4)


def test_knn_counter_counts_the_masks():
    calls = [_knn_inputs(s) for s in range(3)]
    knn_mod.knn(*calls[0])                       # off: not counted
    profiling.enable()
    for c in calls[1:]:
        knn_mod.knn(*c)
    profiling.disable()
    got = knn_mod.knn_work()
    assert got == [(40, int(qv.sum()), 300, int(pv.sum())) for _, qv, _, pv in calls[1:]]
    assert all(qv * nv > 0 for _, qv, _, nv in got)
    profiling.reset()
    assert knn_mod.knn_work() == []


def test_window_step_records_its_phases_in_order():
    cfg = load_config({"shapes": {"max_imu_per_interval": 40, "scan_points": 64,
                                  "map_points": 512},
                       "estimator": {"local_map_width": 4, "sw_max_iter": 1}})
    ep = simulate_episode(n_keyframes=2, scan_points=64, seed=3)
    inp = ep.to_inputs("cpu")
    est = sw.SlidingWindowEstimator(cfg, "cpu")
    carry = est.make_initial_carry(ep.p0, ep.q0, ep.v0, ep.acc0, ep.gyr0,
                                   n_imu=inp.imu_acc.shape[-2], max_sv=0)
    profiling.enable()
    for t in range(2):
        carry, _ = est.step(carry, sw.index_inputs(inp, t))
    profiling.disable()
    rec = profiling.records()
    assert [r.name for r in rec] == WINDOW_SPANS * 2
    assert [r.unit for r in rec] == [0] * 7 + [1] * 7
    assert [r.parent for r in rec] == [-1] + [0] * 6 + [-1] + [7] * 6
    assert len(knn_mod.knn_work()) == 2           # one association a step


@pytest.fixture(scope="module")
def level1_scene():
    """``tests/test_torch_sms1_solve.py``'s level-1 scenario (30 keyframes of
    512 points, seed 9), made by the port: (config, build_problem's inputs,
    correspondences, IMU chain)."""
    cfg = load_config({"estimator": {"search_range": 3, "sms_fusion_level": 1}})
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    ep = simulate_episode(n_keyframes=30, scan_points=512, seed=9, scan_noise=0.01,
                          q_lb=(1, 0, 0, 0), t_lb=(0, 0, 0))
    gnss = simulate_gnss_epochs(ep.gt_p, ep.kf_time, anchor, station, psr_noise=0.5, seed=9)
    p_odo = ep.gt_p + 1.5 * np.random.default_rng(9).normal(size=ep.gt_p.shape)
    sms = batch_mod.build_sms1(cfg, ep.scan, ep.scan_valid, ep.gt_p, ep.gt_q, chunk=32,
                               device="cpu")
    chain = batch_mod.build_imu_chain(cfg, ep.imu_acc, ep.imu_gyr, ep.imu_dt, ep.imu_valid,
                                      device="cpu")
    return cfg, (p_odo, ep.gt_q, ep.kf_time, gnss, anchor, 0.0, station), sms, chain


def _level0_scene():
    cfg = GlioConfig()
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    kf_time, p_true, q_true, p_odo = drifted_trajectory(30, 1.0)
    gnss = simulate_gnss_epochs(p_true, kf_time, anchor, station, epoch_stride=3, seed=0)
    return cfg, (p_odo, q_true, kf_time, gnss, anchor, 0.0, station), None, None


# Each batch solver: (scene, solve(cfg, prob, sms, chain, lm_iters)).
BATCH_SOLVES = {
    "level0": (_level0_scene, lambda cfg, prob, sms, chain, n: batch_mod.optimize_batch(
        cfg, prob, lm_iters=n)),
    "zenith_bias": (_level0_scene, lambda cfg, prob, sms, chain, n:
                    batch_mod.optimize_batch_atm(cfg, prob, lm_iters=n)),
    "level1_pose": ("level1_scene", lambda cfg, prob, sms, chain, n:
                    batch_mod.optimize_batch_sms1(cfg, prob, sms, lm_iters=n)),
    "level1_imu": ("level1_scene", lambda cfg, prob, sms, chain, n:
                   batch_mod.optimize_batch_sms1_imu(cfg, prob, sms, chain, lm_iters=n)),
}


@pytest.mark.parametrize("solve", sorted(BATCH_SOLVES))
def test_batch_solve_records_stages_and_iterations(request, solve):
    """Every batch solver records one span tree: ``batch.solve``, a
    ``batch.stage`` per threshold holding each LM iteration's three parts and
    the stage's cost read."""
    scene, run = BATCH_SOLVES[solve]
    cfg, inputs, sms, chain = (request.getfixturevalue(scene) if isinstance(scene, str)
                               else scene())
    lm_iters = 2
    profiling.enable()
    prob = batch_mod.build_problem(cfg, *inputs, device="cpu")
    run(cfg, prob, sms, chain, lm_iters)
    profiling.disable()
    rec = profiling.records()
    names = [r.name for r in rec]
    iteration = ["batch.assemble", "batch.linear_solve", "batch.trial_cost"]
    stage = ["batch.stage"] + iteration * lm_iters + ["batch.cost_read"]
    assert names == ["batch.build", "batch.solve"] + stage * 4
    assert [r.unit for r in rec] == [0] + [1] * (len(rec) - 1)
    ids = {r.id: r for r in rec}
    for r in rec:
        want = {"batch.build": None, "batch.solve": None, "batch.stage": "batch.solve"}.get(
            r.name, "batch.stage")
        assert (ids[r.parent].name if r.parent >= 0 else None) == want
