"""The batch cell's reference and the comparison that decides ``correct``.

The reference is the frozen copy of the port's level-0 batch
(``frozen/models/batch.py``: ``build_problem``, the analytic assembly, the
block cyclic reduction of ``frozen/solver/banded.py`` and the annealed LM),
which imports nothing of the port. It builds its own problem from the
drive's numpy arrays and solves it from the odometry, as the program does;
no state carries from one solve to the next.

Both sides record, for each LM iteration, the cost at the current point
(from the assembly) and the cost at the trial point (after the CR step);
the step is accepted where the second is lower. ``compare`` gives:

* ``problem_gap``: the largest gap of the problem's float fields, each
  relative to the reference's largest entry (inf where a discrete field,
  such as an epoch's binding or a master satellite, differs);
* ``accept_diff``: the LM iterations whose accept decision differs, read
  by ``control.py`` but not compared: near convergence a decision turns on
  two costs that round-off alone can order either way (the witness reads as
  many as the control);
* ``cost_gap``: the largest relative gap of those costs and of the four
  stage costs;
* ``traj_p_m``: the largest gap of the solved positions (m);
* ``traj_q_rad``: the largest attitude gap of the solved trajectory (rad).
"""

import contextlib
import math

import numpy as np
import torch

from .frozen import precision as P
from .frozen.config import load_config
from .frozen.models import batch as fbatch
from .window import _gap, _rot_gap


class Recorder:
    """Wraps a batch module's ``_lm_stage`` so that, while ``on`` holds a
    list pair, each iteration's current and trial costs are appended to it
    (device scalars: nothing is read to the host inside the solve)."""

    def __init__(self, module):
        self.module = module
        self.on = None
        stage = module._lm_stage

        def recorded(p0, q0, lm_iters, hw, assemble, step, trial_cost, agree=None):
            rec = self.on
            if rec is None:
                return stage(p0, q0, lm_iters, hw, assemble, step, trial_cost, agree)

            def assemble_rec(p, q):
                out = assemble(p, q)
                rec[0].append(out[2])
                return out

            def trial_rec(p, q, w_rel, w_dd):
                c = trial_cost(p, q, w_rel, w_dd)
                rec[1].append(c)
                return c
            return stage(p0, q0, lm_iters, hw, assemble_rec, step, trial_rec, agree)
        self._stage = stage
        module._lm_stage = recorded

    def remove(self):
        self.module._lm_stage = self._stage


def solve_args(config: dict) -> dict:
    s = config["solve"]
    return dict(thresholds=tuple(s["thresholds"]), lm_iters=s["lm_iters"])


class Reference:
    """The frozen build and solve on ``device``; ``lowered``: in float32
    wherever the port computes in float64 (the control)."""

    def __init__(self, config: dict, device, lowered: bool = False):
        self.config, self.device, self.lowered = config, device, lowered
        self.cfg = load_config(config["glio"])

    def _precision(self):
        return P.lowered() if self.lowered else contextlib.nullcontext()

    def build(self, drive):
        init = self.cfg.initialization
        with self._precision():
            return fbatch.build_problem(self.cfg, drive.p_odo, drive.q_true, drive.kf_time,
                                        drive.gnss, np.asarray(init.anc_ecef), 0.0,
                                        np.asarray(init.station_ecef), device=self.device)

    def solve(self, prob):
        """(p, q, stage costs, current costs, trial costs)."""
        robust = fbatch.RobustOpts(**self.config["solve"]["robust"])
        rec = Recorder(fbatch)
        rec.on = ([], [])
        try:
            with self._precision():
                p, q, costs = fbatch.optimize_batch(self.cfg, prob, robust=robust,
                                                    solver=self.cfg.estimator.batch_solver,
                                                    **solve_args(self.config))
        finally:
            rec.remove()
        return p, q, costs, rec.on[0], rec.on[1]


def problem_gap(program, reference) -> float:
    worst = 0.0
    for name, a, b in zip(type(reference)._fields, program, reference):
        if a.dtype.is_floating_point and b.dtype.is_floating_point:
            a64, b64 = a.detach().to("cpu", torch.float64), b.detach().to("cpu", torch.float64)
            if a64.shape != b64.shape:
                return math.inf
            scale = max(float(b64.abs().max()) if b64.numel() else 0.0, 1e-300)
            worst = max(worst, _gap(a64, b64) / scale)
        elif not torch.equal(a.cpu(), b.cpu().to(a.dtype)):
            return math.inf
    return worst


def compare(program, reference) -> dict:
    """``program`` and ``reference``: (problem, p, q, stage costs, current
    costs, trial costs)."""
    pp, p1, q1, c1, cur1, tr1 = program
    rp, p2, q2, c2, cur2, tr2 = reference
    cur1, tr1 = torch.stack(cur1).cpu().double(), torch.stack(tr1).cpu().double()
    cur2, tr2 = torch.stack(cur2).cpu().double(), torch.stack(tr2).cpu().double()
    if cur1.shape != cur2.shape:
        accept, cost = math.inf, math.inf
    else:
        accept = float(((tr1 < cur1) != (tr2 < cur2)).sum())
        both = torch.cat([cur1, tr1, torch.tensor(c1, dtype=torch.float64)])
        ref = torch.cat([cur2, tr2, torch.tensor(c2, dtype=torch.float64)])
        cost = float(((both - ref).abs() / ref.abs().clamp(min=1e-300)).max())
    return {"problem_gap": problem_gap(pp, rp), "accept_diff": accept, "cost_gap": cost,
            "traj_p_m": _gap(p1, p2), "traj_q_rad": _rot_gap(q1, q2)}
