"""The window cells' reference and the comparison that decides ``correct``.

The reference is the frozen copy of the port's plain step (``frozen/``:
the sliding-window step with the plain 5-NN in place of the CUDA kernel),
which imports nothing of the port. It makes its own inputs from the drive's
numpy arrays (``Episode.to_inputs`` of the frozen copy: the GNSS binding,
the whitening) and its own initial carry.

The estimator carries its state from keyframe to keyframe, and small
differences grow over a drive (the JAX package's own stage 1 moves
7.6e-3 m under a 1e-9 m nudge of p0), so the reference follows the program
step by step: each kept keyframe is stepped from the carry the program
started it from. The start is checked by itself: the reference's own
initial carry against the program's, and keyframe 0 stepped from it.

``compare_step`` gives, for one keyframe:

* ``ring_diff``: what the carry counts and holds: the differences of the
  keyframe count and the map ring's head, plus the slots of the map ring,
  the window's scans, the IMU ring and the GNSS ring whose validity
  differs (exact);
* ``factors_diff``: the lidar factors the association selected: the
  difference of ``n_lidar_factors`` plus the slots whose mask or selected
  point differ;
* ``plane_gap``: where both selected a factor, the largest gap of the fit
  normal, the plane offset (m) and the score relative to the reference's;
* ``window_p_m``: the largest gap of the window's positions (m);
* ``window_state``: the largest of the gaps of velocity (m/s), biases,
  receiver clock drift (m/s) and attitude (rad);
* ``prior_gap``: the marginal prior's information JᵀJ and JᵀR, each
  relative to the reference's largest entry (the square root factor itself
  is fixed only up to the sign of each eigenvector);
* ``cost_gap``: the LM's final cost, relative.

The cell's limits name the numbers compared. ``factors_diff`` and
``plane_gap`` are read by ``control.py`` only: round-off alone flips near-tied
selections and the sign of a fit's normal (the same plane), so they do not
part sound runs from the control; the association shows in the others.
"""

import contextlib
import math

import numpy as np
import torch

from .frozen import precision as P
from .frozen.config import load_config
from .frozen.data.episode import Episode
from .frozen.models import sliding_window as fsw
from .frozen.solver import manifold as fmanifold

FROZEN_TYPES = {c.__name__: c for c in (
    fmanifold.WindowState, fsw.GnssKfData, fsw.WindowStateDdt, fsw.KeyframeInput,
    fsw.SlidingWindowCarry, fsw.ReplayCarry, fsw.StepOutput, fsw.LidarMeas)}


def to_frozen(tree):
    """A named tuple of the port's (nested, tensors) as the frozen copy's
    type of the same name, float64 leaves in the working precision."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(P.F64) if tree.dtype == torch.float64 else tree
    return FROZEN_TYPES[type(tree).__name__](*(to_frozen(a) for a in tree))


def to_device(tree, device):
    """A (nested) named tuple of tensors with every tensor on ``device``."""
    if tree is None or isinstance(tree, torch.Tensor):
        return None if tree is None else tree.to(device)
    return type(tree)(*(to_device(a, device) for a in tree))


def _host(x) -> np.ndarray:
    return x.detach().to("cpu", torch.float64).numpy()


def _gap(a, b) -> float:
    """Largest absolute difference; NaN where either side is NaN alone."""
    a, b = _host(a), _host(b)
    if a.shape != b.shape:
        return math.inf
    both_nan = np.isnan(a) & np.isnan(b)
    d = np.where(both_nan, 0.0, np.abs(a - b))
    return float(d.max()) if d.size else 0.0


def tree_gap(a, b) -> float:
    """Largest absolute difference over every leaf of two carries."""
    if isinstance(a, torch.Tensor):
        return _gap(a, b)
    return max((tree_gap(x, y) for x, y in zip(a, b)), default=0.0)


def _rot_gap(qa, qb) -> float:
    qa, qb = _host(qa), _host(qb)
    w = np.sum(qa * qb, -1)
    v = np.linalg.norm(qb[..., 1:] * qa[..., :1] - qa[..., 1:] * qb[..., :1]
                       - np.cross(qa[..., 1:], qb[..., 1:]), axis=-1)
    return float(np.max(2.0 * np.arctan2(v, np.abs(w))))


def _rel(a, b) -> float:
    a, b = _host(a), _host(b)
    scale = max(float(np.max(np.abs(b))), 1e-300)
    return float(np.max(np.abs(a - b))) / scale


def compare_step(program, reference) -> dict:
    """The numbers compared for one keyframe: ``program`` and ``reference``
    are each (carry after the step, StepOutput, the step's association)."""
    pc, po, pm = program
    rc, ro, rm = reference
    pmask, rmask = _host(pm.mask) > 0, _host(rm.mask) > 0
    same_pt = np.all(_host(pm.points) == _host(rm.points), axis=-1)
    both = pmask & rmask
    factors = (abs(int(po.n_lidar_factors) - int(ro.n_lidar_factors))
               + int(np.sum(pmask != rmask)) + int(np.sum(both & ~same_pt)))
    plane = 0.0
    if both.any():
        dn = np.abs(_host(pm.normal) - _host(rm.normal)).max(-1)
        dd = np.abs(_host(pm.d) - _host(rm.d))
        ds = np.abs(_host(pm.score) - _host(rm.score)) / np.maximum(np.abs(_host(rm.score)),
                                                                   1e-300)
        plane = float(np.max(np.maximum(np.maximum(dn, dd), ds)[both]))
    pw, rw = pc.base.window, rc.base.window
    state = max(_gap(pw.v, rw.v), _gap(pw.ba, rw.ba), _gap(pw.bg, rw.bg), _gap(pc.ddt, rc.ddt),
                _rot_gap(pw.q, rw.q))
    prior = 0.0
    if bool(pc.base.prior_valid) != bool(rc.base.prior_valid):
        prior = math.inf
    elif bool(rc.base.prior_valid):
        def info(c):
            sj = c.base.prior_sqrt_jac.to(torch.float64)
            return sj.T @ sj, sj.T @ c.base.prior_sqrt_res.to(torch.float64)
        (hp, bp), (hr, br) = info(pc), info(rc)
        prior = max(_rel(hp, hr), _rel(bp, br))
    cost = abs(float(po.cost) - float(ro.cost)) / max(abs(float(ro.cost)), 1e-300)
    ring = (abs(int(pc.base.kf_count) - int(rc.base.kf_count))
            + abs(int(pc.base.map_head) - int(rc.base.map_head))
            + sum(int(np.sum(_host(a) != _host(b))) for a, b in (
                (pc.base.map_slot_valid, rc.base.map_slot_valid),
                (pc.base.window_scan_valid, rc.base.window_scan_valid),
                (pc.imu_valid, rc.imu_valid), (pc.gnss_win.valid, rc.gnss_win.valid))))
    return {"ring_diff": float(ring), "factors_diff": float(factors), "plane_gap": plane,
            "window_p_m": _gap(pw.p, rw.p), "window_state": state,
            "prior_gap": prior, "cost_gap": cost}


class Reference:
    """The frozen step on ``device``; ``lowered``: in float32 wherever the
    port computes in float64 (the control)."""

    def __init__(self, glio: dict, device, lowered: bool = False):
        self.lowered = lowered
        self.device = device
        with self._precision():
            self.cfg = load_config(glio)
            self.est = fsw.SlidingWindowEstimator(self.cfg, device)
        associate = self.est._associate
        self._meas = [None]

        def captured(*args, **kwargs):
            self._meas[0] = associate(*args, **kwargs)
            return self._meas[0]
        self.est._associate = captured

    def _precision(self):
        return P.lowered() if self.lowered else contextlib.nullcontext()

    def inputs(self, ep, keyframes: int = None):
        """The drive's first ``keyframes`` (all: None) as the frozen
        ``KeyframeInput``, made by the frozen ``Episode.to_inputs``."""
        n = keyframes
        mine = Episode(kf_time=ep.kf_time[:n], imu_acc=ep.imu_acc[:n], imu_gyr=ep.imu_gyr[:n],
                       imu_dt=ep.imu_dt[:n], imu_valid=ep.imu_valid[:n], scan=ep.scan[:n],
                       scan_valid=ep.scan_valid[:n], p0=ep.p0, q0=ep.q0, v0=ep.v0,
                       acc0=ep.acc0, gyr0=ep.gyr0, gnss=ep.gnss)
        with self._precision():
            return mine.to_inputs(self.device)

    def initial_carry(self, ep, n_imu: int, max_sv: int):
        with self._precision():
            return self.est.make_initial_carry(ep.p0, ep.q0, ep.v0, ep.acc0, ep.gyr0,
                                               n_imu=n_imu, max_sv=max_sv)

    def step(self, carry, inputs, t: int):
        """(carry, StepOutput, association) of keyframe ``t`` from ``carry``."""
        with self._precision():
            carry = to_frozen(carry)
            new, out = self.est.step(carry, fsw.index_inputs(to_frozen(inputs), t))
            return new, out, self._meas[0]
