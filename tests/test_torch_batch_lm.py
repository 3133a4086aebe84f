"""The LM loop every batch solve runs (``models/batch.py::_lm_loop``), on a
tiny band with scripted costs, held to the rules of the batch's damped
Gauss-Newton stage:

* λ starts at 1e-4 and damps the diagonal blocks as λ·max(diag, 1);
* an accepted step (trial cost strictly below the current one) takes λ ×0.3,
  a rejected one ×5, and λ stays within [1e-9, 1e6];
* a rejected step leaves every state tensor as it was, bit for bit;
* the current cost is the assembly's (frozen IRLS weights, level 0) or, where
  the stage carries its cost (level 1), the last accepted trial's, seeded by
  the cost at the start.

The band's diagonal is zero, so the damped diagonal the step sees is λ itself.
"""

import pytest
import torch

from glio_tpu_torch.models import batch as batch_mod

F64 = torch.float64
T, HW, D = 3, 1, 2


def _lams(accepts):
    """The λ of each iteration by the rules, in Python floats."""
    lam, out = 1e-4, []
    for ok in accepts:
        out.append(lam)
        lam = min(max(lam * 0.3 if ok else lam * 5.0, 1e-9), 1e6)
    return out


class Script:
    """An LM problem whose trial costs follow ``trial_costs``; records the λ
    each step sees and each trial state."""

    def __init__(self, trial_costs, current=None):
        self.trial_costs = list(trial_costs)
        self.current = current
        self.lams, self.trials = [], []

    def assemble(self, *state):
        band = torch.zeros((T, 2 * HW + 1, D, D), dtype=F64)
        grad = torch.ones((T, D), dtype=F64)
        if self.current is None:          # a carried cost: no cost of its own
            return band, grad
        return band, grad, torch.tensor(self.current, dtype=F64), "frozen"

    def step(self, band, grad):
        diag = torch.diagonal(band[:, HW], dim1=-2, dim2=-1)
        assert torch.all(diag == diag[0, 0])
        self.lams.append(float(diag[0, 0]))
        return torch.full((T, D), float(len(self.lams)), dtype=F64)

    def retract(self, x, y, dx):
        trial = (x + dx, y - 2.0 * dx[:, :1])
        self.trials.append(trial)
        return trial

    def trial_cost(self, *args):
        if self.current is not None:
            assert args[-1] == "frozen"
        return torch.tensor(self.trial_costs[len(self.trials) - 1], dtype=F64)


def _state():
    g = torch.Generator().manual_seed(0)
    return torch.randn((T, D), generator=g, dtype=F64), torch.randn((T, 1), generator=g,
                                                                      dtype=F64)


@pytest.mark.parametrize("carried", [False, True])
def test_lm_damping_schedule_and_clamps(carried):
    """12 accepts drive λ to its floor, 25 rejects to its ceiling, 3 accepts
    bring it down again."""
    accepts = [True] * 12 + [False] * 25 + [True] * 3
    if carried:
        # From 100: each accepted trial 1 below the carried cost, each
        # rejected one 1 above it.
        costs = [100.0 - sum(accepts[:k]) + (-1.0 if ok else 1.0)
                 for k, ok in enumerate(accepts)]
        s = Script(costs)
        _, cost = batch_mod._lm_loop(_state(), len(accepts), HW, s.assemble, s.step,
                                     s.retract, s.trial_cost,
                                     cost=torch.tensor(100.0, dtype=F64))
        assert float(cost) == 100.0 - sum(accepts)
    else:
        s = Script([0.5 if ok else 2.0 for ok in accepts], current=1.0)
        _, cost = batch_mod._lm_loop(_state(), len(accepts), HW, s.assemble, s.step,
                                     s.retract, s.trial_cost)
        assert cost is None
    want = _lams(accepts)
    assert s.lams == want
    assert want[0] == 1e-4 and min(want) == 1e-9 and max(want) == 1e6


def test_lm_rejected_step_leaves_the_state_bit_for_bit():
    """Accept, reject, reject on a tie (strictly lower wins), accept: the
    state after each is the trial or the one before it, bit for bit."""
    x0, y0 = _state()
    s = Script([0.5, 2.0, 1.0, 0.25], current=1.0)
    starts = []          # the state at the start of each iteration

    def assemble(x, y):
        starts.append((x.clone(), y.clone()))
        return s.assemble(x, y)
    end = batch_mod._lm_loop((x0, y0), 4, HW, assemble, s.step, s.retract, s.trial_cost)[0]
    for k, accepted in enumerate([True, False, False, True]):
        got = (starts + [end])[k + 1]
        want = s.trials[k] if accepted else starts[k]
        assert all(torch.equal(a, b) for a, b in zip(got, want)), k
    assert s.lams == _lams([True, False, False, True])


def test_lm_carried_cost_is_the_last_accepted_trials():
    """Level 1's carried cost: a trial is held to the last accepted trial's
    cost, not to a cost of the assembly; the loop returns that cost."""
    x0, y0 = _state()
    # From 10: 9 accepted; 9.5 rejected (below the start, above 9); 9.2
    # rejected (below the rejected 9.5, above 9); 8 accepted; 8.5 rejected.
    s = Script([9.0, 9.5, 9.2, 8.0, 8.5])
    (x, y), cost = batch_mod._lm_loop((x0, y0), 5, HW, s.assemble, s.step, s.retract,
                                      s.trial_cost, cost=torch.tensor(10.0, dtype=F64))
    assert float(cost) == 8.0
    assert torch.equal(x, s.trials[3][0]) and torch.equal(y, s.trials[3][1])
    assert s.lams == _lams([True, False, False, True, False])


def test_level0_stage_is_the_loop_over_pose():
    """``_lm_stage`` (the level-0 signature the benchmark's reference wraps):
    (p, q) through ``_retract``, each rank's costs through ``agree``."""
    p0 = torch.zeros((T, 3), dtype=F64)
    q0 = torch.tensor([[1.0, 0.0, 0.0, 0.0]] * T, dtype=F64)
    agreed = []

    def assemble(p, q):
        band = torch.zeros((T, 2 * HW + 1, 6, 6), dtype=F64)
        cost = torch.tensor(1.0, dtype=F64)
        return band, torch.ones((T, 6), dtype=F64), cost, "w_rel", "w_dd"

    def trial_cost(p, q, w_rel, w_dd):
        assert (w_rel, w_dd) == ("w_rel", "w_dd")
        return torch.tensor(0.5, dtype=F64)

    def agree(cost, trial):
        agreed.append((float(cost), float(trial)))
        return cost, trial
    step = torch.arange(T * 6, dtype=F64).reshape(T, 6) * 1e-3
    p, q = batch_mod._lm_stage(p0, q0, 1, HW, assemble, lambda band, grad: step, trial_cost,
                               agree)
    p_want, q_want = batch_mod._retract(p0, q0, step.reshape(-1))
    assert torch.equal(p, p_want) and torch.equal(q, q_want)
    assert agreed == [(1.0, 0.5)]
