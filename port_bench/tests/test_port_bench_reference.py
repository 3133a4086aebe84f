"""Each driver's reference against the port on a tiny drive (CPU): sound runs
are correct, the control and the planted faults are not.

These drive the rest of a run without the look for a card: the port's
kernels run their plain versions on the CPU.
"""

import time

import pytest
import torch

from glio_tpu_torch.models import batch as port_batch
from glio_tpu_torch.models import sliding_window as port_sw
from port_bench import control
from port_bench.harness import cells, checks, runner

CPU = torch.device("cpu")
SEED = 2**31 + 17
DRIVER = {"window.tc": "window", "batch.l0": "batch"}


def run(name: str):
    over = control.small_overrides(DRIVER[name])
    over["run"] = {**over.get("run", {}), "check_units": 2}
    return runner.run_cell(name, SEED, 1.5, False, started=time.time(), device=CPU,
                           overrides=over)


@pytest.mark.parametrize("name", list(DRIVER))
def test_reference_agrees_with_the_port(name):
    res = run(name)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0.0 for c in res["checks"].values()), res["checks"]


@pytest.mark.parametrize("name", list(DRIVER))
def test_control_fails_where_the_witness_does_not(name):
    """The float32 control breaks a limit, and on each number it breaks the
    round-off witness reads lower (the limits are set at the cell's sizes,
    which these tiny drives are not)."""
    limits = cells.load_cell(name).run["limits"]
    over = control.small_overrides(DRIVER[name])
    over["run"] = {**over.get("run", {}), "check_units": 1}
    rec = control.readings(name, SEED, 1.5, False, CPU, overrides=over)
    assert rec["result"]["correct"], rec["sound"]
    assert set(rec["witness"]) >= set(limits) and set(rec["control"]) >= set(limits)
    broken = [k for k, v in limits.items() if not checks.passes(rec["control"][k], v)]
    assert broken, rec
    assert all(rec["witness"][k] < rec["control"][k] for k in broken), rec


def _window_unchanged(monkeypatch):
    step = port_sw.SlidingWindowEstimator.step

    def unchanged(self, carry, inp):
        return carry, step(self, carry, inp)[1]
    monkeypatch.setattr(port_sw.SlidingWindowEstimator, "step", unchanged)


def _window_half(monkeypatch):
    associate = port_sw.SlidingWindowEstimator._associate

    def half(self, window, scans, scan_valid, map_points, map_valid):
        kept = scan_valid.clone()
        kept[:, 1::2] = False
        return associate(self, window, scans, kept, map_points, map_valid)
    monkeypatch.setattr(port_sw.SlidingWindowEstimator, "_associate", half)


def _window_altered(monkeypatch):
    step = port_sw.SlidingWindowEstimator.step

    def altered(self, carry, inp):
        new, out = step(self, carry, inp)
        w = new.base.window
        w = w._replace(p=w.p + torch.tensor([0.01, 0.0, 0.0], dtype=w.p.dtype))
        return new._replace(base=new.base._replace(window=w)), out._replace(p=w.p[-1])
    monkeypatch.setattr(port_sw.SlidingWindowEstimator, "step", altered)


def _batch_unchanged(monkeypatch):
    solve = port_batch.optimize_batch

    def unchanged(cfg, prob, **kw):
        return (prob.p_odo, prob.q_odo, solve(cfg, prob, **kw)[2])
    monkeypatch.setattr(port_batch, "optimize_batch", unchanged)


def _batch_half(monkeypatch):
    build = port_batch.build_problem

    def half(*args, **kw):
        prob = build(*args, **kw)
        valid = prob.ep_valid.clone()
        valid[1::2] = False
        return prob._replace(ep_valid=valid)
    monkeypatch.setattr(port_batch, "build_problem", half)


def _batch_altered(monkeypatch):
    solve = port_batch.optimize_batch

    def altered(cfg, prob, **kw):
        p, q, costs = solve(cfg, prob, **kw)
        return p + torch.tensor([0.01, 0.0, 0.0], dtype=p.dtype), q, costs
    monkeypatch.setattr(port_batch, "optimize_batch", altered)


FAULTS = [("window.tc", _window_unchanged), ("window.tc", _window_half),
          ("window.tc", _window_altered), ("batch.l0", _batch_unchanged),
          ("batch.l0", _batch_half), ("batch.l0", _batch_altered)]


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    res = run(name)
    assert not res["correct"], res["checks"]
    assert res["failed"] > 0
