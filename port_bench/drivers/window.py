"""The window driver: GLIO's real-time stage, one keyframe a unit.

Set-up simulates the cell's drive from the seed, hands it to the port
(``Episode.to_inputs``), builds ``SlidingWindowEstimator`` and steps the
first ``warm_units`` keyframes untimed. A unit is one ``step`` of the next
keyframe from the carry the last one left, as ``replay_from`` does; the
harness adds no sync between steps. The window ends when the drive does, if
it has not ended before.

The driver keeps, by a reservoir drawn from the seed, ``check_units``
window keyframes with the carry each started from and what it produced
(carry, ``StepOutput`` and the association the step selected, read by
wrapping the estimator's ``_associate``), and keyframe 0 with the initial
carry: ``check`` holds them against the frozen reference once the window
has closed; ``readings`` gives the witness and the control of the same
keyframes (``control.py``).
"""

import dataclasses
import os

import torch

from ..harness.reservoir import Reservoir
from ..reference import window as reference
from ..traffic import generate


def program_config(cell) -> dict:
    """The configuration as the port loads it: the file's ``glio`` sections,
    the scan width from the traffic."""
    glio = {k: dict(v) for k, v in cell.config["glio"].items()}
    glio.setdefault("shapes", {})["scan_points"] = cell.traffic["scan_points"]
    return glio


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.dev = cell, seed, device
        self.knn_calls = []        # (Q, N, query_valid, points_valid) in traced runs
        self._meas = [None]

    # -- set-up ---------------------------------------------------------------

    def setup(self):
        from glio_tpu_torch.config import load_config
        from glio_tpu_torch.data import episode as port_episode
        from glio_tpu_torch.models import sliding_window as sw
        self.sw = sw
        self.glio = program_config(self.cell)
        cfg = load_config(self.glio)
        init = cfg.initialization
        self.drive = generate.generate(self.cell.traffic, self.seed, init.anc_ecef,
                                       init.station_ecef)
        ep = self.drive
        self.n_keyframes = ep.num_keyframes
        port_ep = port_episode.Episode(
            **{f.name: getattr(ep, f.name) for f in dataclasses.fields(ep) if f.name != "gnss"},
            gnss=port_episode.GnssEpochs(**dataclasses.asdict(ep.gnss)))
        self.inputs = port_ep.to_inputs(self.dev)
        self.est = sw.SlidingWindowEstimator(cfg, self.dev)
        self.n_imu = self.inputs.imu_acc.shape[-2]
        self.max_sv = self.inputs.gnss.sv_valid.shape[-1]
        carry0 = self.est.make_initial_carry(ep.p0, ep.q0, ep.v0, ep.acc0, ep.gyr0,
                                             n_imu=self.n_imu, max_sv=self.max_sv)
        associate = self.est._associate

        def captured(*args, **kwargs):
            out = associate(*args, **kwargs)
            self._meas[0] = out
            return out
        self.est._associate = captured

        carry = carry0
        for t in range(self.cell.run["warm_units"]):
            new, out = self.est.step(carry, sw.index_inputs(self.inputs, t))
            if t == 0:
                self.start = (0, carry0, new, out, self._meas[0])
            carry = new
        self.carry = carry
        self.t = self.cell.run["warm_units"]
        self.kept = Reservoir(self.cell.run["check_units"], self.seed)

    # -- the timed path ---------------------------------------------------------

    def step(self, i: int) -> bool:
        t = self.t
        if t >= self.n_keyframes:
            return False
        slot = self.kept.slot(i)
        before = self.carry
        self.carry, out = self.est.step(before, self.sw.index_inputs(self.inputs, t))
        self.kept.put(slot, (t, before, self.carry, out, self._meas[0]))
        self.t = t + 1
        return True

    def metrics(self, window_s: float, n: int) -> dict:
        return {"keyframe_ms": 1e3 * window_s / n}

    # -- traced runs --------------------------------------------------------------

    def host_begin(self):
        pass

    def trace_begin(self):
        """Record each kNN call's sizes and masks (their counts are read
        after the window, so the trace holds no extra launch or sync)."""
        knn = self.sw.knn

        def counted(query, query_valid, points, points_valid, k=5):
            self.knn_calls.append((query.shape[0], points.shape[0], query_valid,
                                   points_valid))
            return knn(query, query_valid, points, points_valid, k)
        self._knn = knn
        self.sw.knn = counted

    def trace_end(self):
        self.sw.knn = self._knn

    # -- correctness ----------------------------------------------------------------

    def release(self):
        """Drop the program's state that no kept unit needs."""
        self.est = self.inputs = self.carry = None

    def check(self) -> list:
        """One dict of compared numbers for the start and each kept keyframe."""
        ref = reference.Reference(self.glio, self.dev)
        kept = self.kept.kept()
        ref_inputs = ref.inputs(self.drive, 1 + max([0] + [k[0] for k in kept]))
        values = []
        _, carry0, after, out, meas = self.start
        own0 = ref.initial_carry(self.drive, self.n_imu, self.max_sv)
        start = reference.compare_step((after, out, meas), ref.step(own0, ref_inputs, 0))
        start["start_carry"] = reference.tree_gap(carry0, own0)
        values.append(start)
        for t, before, after, out, meas in kept:
            got = ref.step(reference.to_frozen(before), ref_inputs, t)
            v = reference.compare_step((after, out, meas), got)
            v["start_carry"] = 0.0
            values.append(v)
        return values


    def readings(self) -> tuple:
        """(witness, control): rows of ``check``'s numbers for the start and
        each kept keyframe, each against the reference on the card. The
        witness is the reference on the host's CPU from the program's carry
        (at the start, from its own initial carry): the same plain
        operations, reduced in another order, as a sound change of the
        program that only reorders sums would be. The control is the
        float32 reference on the card."""
        cpu = torch.device("cpu")
        ref = reference.Reference(self.glio, self.dev)
        wit = reference.Reference(self.glio, cpu)
        ctl = reference.Reference(self.glio, self.dev, lowered=True)
        kept = self.kept.kept()
        n = 1 + max([0] + [k[0] for k in kept])
        ref_in, wit_in = ref.inputs(self.drive, n), wit.inputs(self.drive, n)
        ctl_in = ctl.inputs(self.drive, n)
        own0 = ref.initial_carry(self.drive, self.n_imu, self.max_sv)
        wit0 = wit.initial_carry(self.drive, self.n_imu, self.max_sv)
        ctl0 = ctl.initial_carry(self.drive, self.n_imu, self.max_sv)
        threads = torch.get_num_threads()
        torch.set_num_threads(os.cpu_count() or 1)
        try:
            r = ref.step(own0, ref_in, 0)
            w = reference.compare_step(wit.step(wit0, wit_in, 0), r)
            w["start_carry"] = reference.tree_gap(wit0, own0)
            c = reference.compare_step(ctl.step(ctl0, ctl_in, 0), r)
            c["start_carry"] = reference.tree_gap(ctl0, own0)
            witness, control = [w], [c]
            for t, before, *_ in kept:
                r = ref.step(before, ref_in, t)
                witness.append(reference.compare_step(
                    wit.step(reference.to_device(before, cpu), wit_in, t), r))
                control.append(reference.compare_step(ctl.step(before, ctl_in, t), r))
        finally:
            torch.set_num_threads(threads)
        return witness, control


def knn_counts(calls) -> list:
    """(Q, valid queries, N, valid points) of each recorded kNN call."""
    return [(q, int(qv.sum()), n, int(pv.sum())) for q, n, qv, pv in calls]

