"""The batch driver: GLIO's global stage, one solve of a whole drive a unit.

Set-up simulates the traffic's drives from the seed and solves the last of
them once untimed. Unit i solves drive i mod n: ``build_problem`` (host)
and ``optimize_batch`` from the odometry, closed by a device sync, so no
solve sees the inputs of the one before. The host time of each
``build_problem`` is kept; those of a traced run's unprofiled units are
``batch.build_ms``.

A reservoir drawn from the seed keeps ``check_units`` solves with their
problem, result and each LM iteration's current and trial costs (read by
wrapping the port's ``_lm_stage``, no host read inside the solve); ``check``
holds them against the frozen reference once the window has closed;
``readings`` gives the witness and the control of the same solves
(``control.py``).
"""

import dataclasses
import time

import numpy as np
import torch

from ..harness.reservoir import Reservoir
from ..reference import batch as reference
from ..traffic import generate


ODOMETRY_ULPS = 4


def _moved(p_odo: np.ndarray) -> np.ndarray:
    """The odometry moved by round-off: ``ODOMETRY_ULPS`` units in the last
    place of each coordinate (of 1 m below 1 m)."""
    return p_odo + np.maximum(np.abs(p_odo), 1.0) * (ODOMETRY_ULPS * np.finfo(np.float64).eps)


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.dev = cell, seed, device
        self.build_s = []
        self.host_build_s = []

    def setup(self):
        from glio_tpu_torch.config import load_config
        from glio_tpu_torch.data.episode import GnssEpochs
        from glio_tpu_torch.models import batch as batch_mod
        self.bm = batch_mod
        self.cfg = load_config(self.cell.config["glio"])
        init = self.cfg.initialization
        self.anchor = np.asarray(init.anc_ecef)
        self.station = np.asarray(init.station_ecef)
        self.drives = generate.generate(self.cell.traffic, self.seed, init.anc_ecef,
                                        init.station_ecef)
        self.gnss = [GnssEpochs(**dataclasses.asdict(d.gnss)) for d in self.drives]
        self.robust = batch_mod.RobustOpts(**self.cell.config["solve"]["robust"])
        self.args = reference.solve_args(self.cell.config)
        self.rec = reference.Recorder(batch_mod)
        n = len(self.drives)
        for w in range(self.cell.run["warm_units"]):
            self._solve(n - 1 - w % n)
        self.kept = Reservoir(self.cell.run["check_units"], self.seed)

    def _solve(self, d: int):
        drive = self.drives[d]
        t0 = time.perf_counter()
        prob = self.bm.build_problem(self.cfg, drive.p_odo, drive.q_true, drive.kf_time,
                                     self.gnss[d], self.anchor, 0.0, self.station,
                                     device=self.dev)
        self.build_s.append(time.perf_counter() - t0)
        p, q, costs = self.bm.optimize_batch(self.cfg, prob, solver=self.cfg.estimator.batch_solver,
                                             robust=self.robust, **self.args)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return prob, p, q, costs

    # -- the timed path ---------------------------------------------------------

    def step(self, i: int) -> bool:
        slot = self.kept.slot(i)
        self.rec.on = None if slot is None else ([], [])
        d = i % len(self.drives)
        out = self._solve(d)
        if slot is not None:
            self.kept.put(slot, (d, *out, *self.rec.on))
        self.rec.on = None
        return True

    def metrics(self, window_s: float, n: int) -> dict:
        return {"batch_solve_s": window_s / n}

    def host_begin(self):
        self.build_s = []

    def trace_begin(self):
        """The build times so far are the unprofiled units'."""
        self.host_build_s = self.build_s
        self.build_s = []

    def trace_end(self):
        pass

    # -- correctness ----------------------------------------------------------------

    def release(self):
        self.rec.remove()

    def check(self) -> list:
        ref = reference.Reference(self.cell.config, self.dev)
        values = []
        for d, *program in self.kept.kept():
            prob = ref.build(self.drives[d])
            values.append(reference.compare(program, (prob, *ref.solve(prob))))
        return values

    def readings(self) -> tuple:
        """(witness, control): rows of ``check``'s numbers for each kept
        solve, of the reference on the drive with its odometry moved by
        round-off, and of the float32 reference, each against the reference."""
        ref = reference.Reference(self.cell.config, self.dev)
        ctl = reference.Reference(self.cell.config, self.dev, lowered=True)
        witness, control = [], []
        for d, *_ in self.kept.kept():
            drive = self.drives[d]
            rp = ref.build(drive)
            r = (rp, *ref.solve(rp))
            wp = ref.build(dataclasses.replace(drive, p_odo=_moved(drive.p_odo)))
            witness.append(reference.compare((wp, *ref.solve(wp)), r))
            cp = ctl.build(drive)
            control.append(reference.compare((cp, *ctl.solve(cp)), r))
        return witness, control
