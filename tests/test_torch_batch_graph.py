"""The level-0 batch LM's closures as data-driven functions
(``models/batch.py::lm_closures``), off the card.

On a CUDA device ``solve_batch_once`` hands ``_lm_stage`` its assembly, step
and trial cost as the replays of CUDA graphs, one set kept for the latest signature, with the
annealing threshold as a 0-d tensor of the graphs' data. Here, on the CPU:

* the threshold as a 0-d tensor and the scalars filled on the device
  (``_scalar``) give the rows, Jacobians, bands and costs of the Python float
  and the host-copied scalars, bit for bit, at each annealing threshold;
* the signature keeps apart what a graph depends on (the band half-width,
  the Doppler rows, the solver, the plan's scatter groups) and is shared by
  problems of equal shapes and by every threshold;
* off the card each closure is the direct call, tallied
  ``batch.graph.eager``, nothing is captured, and a stage gives what the
  closures over the Python float threshold gave.
"""

import dataclasses

import numpy as np
import pytest
import torch

from glio_tpu_torch.config import GlioConfig
from glio_tpu_torch.data.simulator import drifted_trajectory, simulate_gnss_epochs
from glio_tpu_torch.models import batch
from glio_tpu_torch.utils import profiling

F64 = torch.float64
THRESHOLDS = (1e9, 10.0, 8.0, 6.0)
ROBUST = batch.RobustOpts(dd_huber=1.0, epoch_gate=2.0, rel_huber=5.0)


def _cfg(**estimator):
    cfg = GlioConfig()
    return cfg.replace(estimator=dataclasses.replace(cfg.estimator, **estimator))


def _problem(cfg, seed=4, T=60):
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    kf_time, p_true, q_true, p_odo = drifted_trajectory(T)
    gnss = simulate_gnss_epochs(p_true, kf_time, anchor, station, psr_noise=0.5, seed=seed)
    return batch.build_problem(cfg, p_odo, q_true, kf_time, gnss, anchor, 0.0, station,
                               device="cpu")


@pytest.fixture(scope="module")
def problem():
    cfg = _cfg()
    return cfg, _problem(cfg)


def _host_scalar(value, like):
    """``_scalar`` as it was: a copy from the host."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("robust", [batch.NO_ROBUST, ROBUST], ids=["no_robust", "robust"])
@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_tensor_threshold_gives_the_float_paths_bits(problem, monkeypatch, threshold, robust):
    """At the odometry moved by ~8 m (so that the thresholds below 1e9
    down-weight some rows and not others): the DD rows and their Jacobian,
    the assembled band, gradient, cost and weights, and the trial cost under
    those weights."""
    cfg, prob = problem
    hw = cfg.estimator.search_range + 1
    plan = batch.assembly_plan(prob, hw)
    g = torch.Generator().manual_seed(1)
    p = prob.p_odo + 8.0 * torch.randn(prob.p_odo.shape, generator=g, dtype=F64)
    q = prob.q_odo
    R_el = batch.r_ecef_local(prob.anchor_ecef, prob.yaw_enu_local)

    def evaluate(th):
        rows = batch._dd_row_jac(p, R_el, prob, th, None, robust)
        assembled = batch._assemble_core_impl(p, q, prob, th, hw, robust=robust, plan=plan)
        trial = batch._total_cost(p, q, prob, th, *assembled[3:])
        return (*rows, *assembled, trial)

    with monkeypatch.context() as m:
        m.setattr(batch, "_scalar", _host_scalar)
        want = evaluate(threshold)
    got = evaluate(torch.full((), threshold, dtype=F64))
    assert _equal(got, want)
    if threshold < 1e9:       # the threshold takes effect
        assert not torch.equal(want[0], evaluate(1e9)[0])
        assert not torch.equal(want[0], evaluate(threshold + 2.0)[0])


def _keys(monkeypatch, runs):
    """The graph signature of each ``solve_batch_once`` of ``runs``
    ((cfg, problem, threshold, solver)), as ``lm_closures`` would key it."""
    keys, closures = [], batch.lm_closures

    def spy(data, kind, *fns):
        keys.append(batch._graph_key(data, kind))
        return closures(data, kind, *fns)
    monkeypatch.setattr(batch, "lm_closures", spy)
    for cfg, prob, threshold, solver in runs:
        batch.solve_batch_once(cfg, prob, prob.p_odo, prob.q_odo, threshold, 0, solver=solver)
    return keys


def test_signature_is_shared_by_equal_shapes_and_every_threshold(problem, monkeypatch):
    cfg, prob = problem
    other = _problem(cfg, seed=5)
    assert not torch.equal(other.psr_rov, prob.psr_rov)
    keys = _keys(monkeypatch, [(cfg, prob, th, "direct") for th in THRESHOLDS]
                 + [(cfg, other, 6.0, "direct")])
    assert len(set(keys)) == 1


def test_signature_separates_what_a_graph_depends_on(problem, monkeypatch):
    """Another trajectory length, another band half-width, the Doppler rows,
    another solver, or the same shapes with two epochs bound to one keyframe
    (another scatter grouping)."""
    cfg, prob = problem
    narrow = _cfg(search_range=cfg.estimator.search_range - 1)
    dopp = _cfg(doppler_in_batch=True)
    left = prob.ep_left.clone()
    left[1] = left[0]
    shared = prob._replace(ep_left=left)
    hw = cfg.estimator.search_range + 1
    assert batch.assembly_plan(prob, hw).dd[4].groups is None
    assert len(batch.assembly_plan(shared, hw).dd[4].groups) == 2
    keys = _keys(monkeypatch, [(cfg, prob, 6.0, "direct"),
                               (cfg, _problem(cfg, T=63), 6.0, "direct"),
                               (narrow, _problem(narrow), 6.0, "direct"),
                               (dopp, _problem(dopp), 6.0, "direct"),
                               (cfg, prob, 6.0, "chol_pcg"),
                               (cfg, prob, 6.0, "pcg"),
                               (cfg, shared, 6.0, "direct")])
    assert len(set(keys)) == len(keys)


def test_off_the_card_the_closures_are_direct_calls(problem):
    """A stage of 2 iterations: 2 × 3 direct calls, no capture, no replay,
    no graph kept; (p, q) and the cost are those of ``_lm_stage`` over the
    closures with the Python float threshold, bit for bit."""
    cfg, prob = problem
    hw = cfg.estimator.search_range + 1
    plan = batch.assembly_plan(prob, hw)
    names = ("batch.graph.captures", "batch.graph.replays", "batch.graph.eager")
    before = profiling.tallies()
    graphs = batch._GRAPH_SET
    got = batch.solve_batch_once(cfg, prob, prob.p_odo, prob.q_odo, 8.0, 2,
                                 robust=ROBUST, plan=plan)
    after = profiling.tallies()
    assert [after.get(n, 0) - before.get(n, 0) for n in names] == [0, 0, 6]
    assert batch._GRAPH_SET is graphs
    p, q = batch._lm_stage(
        prob.p_odo, prob.q_odo, 2, hw,
        lambda p, q: batch._assemble_core_impl(p, q, prob, 8.0, hw, robust=ROBUST, plan=plan),
        lambda band, grad: batch._solve_step(band, grad, "direct"),
        lambda p, q, w_rel, w_dd: batch._total_cost(p, q, prob, 8.0, w_rel, w_dd))
    assert _equal(got, (p, q, batch._total_cost(p, q, prob, 8.0)))


def test_one_graph_set_is_kept_and_another_signature_replaces_it(monkeypatch):
    """``_graph_set``'s bookkeeping (on the card only in a solve; here on CPU
    tensors, which it only clones): data of the same shapes and kind reuse
    the kept set, which holds its own copy of the first data; another shape
    or kind replaces it, and the set it replaced is not kept."""
    monkeypatch.setattr(batch, "_GRAPH_SET", None)
    data = (torch.zeros(3, dtype=F64), torch.ones(2))
    first = batch._graph_set(data, ("k",))
    assert torch.equal(first.data[0], data[0]) and first.data[0] is not data[0]
    assert batch._graph_set((torch.ones(3, dtype=F64), torch.zeros(2)), ("k",)) is first
    assert batch._GRAPH_SET is first
    longer = batch._graph_set((torch.zeros(4, dtype=F64), torch.ones(2)), ("k",))
    assert longer is not first and batch._GRAPH_SET is longer
    other = batch._graph_set((torch.zeros(4, dtype=F64), torch.ones(2)), ("other",))
    assert other is not longer and batch._GRAPH_SET is other
    assert batch._graph_set(data, ("k",)) is not first
