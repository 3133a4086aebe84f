"""Converters from the JAX package's values to the port's, through numpy.

None of these imports jax: a caller turns JAX arrays into numpy first
(``jax.tree.map(np.asarray, tree)``), and the converters read fields by name.

* ``config_from_glio``: a ``glio_tpu.config.GlioConfig`` → the port's.
* ``inputs_from_numpy``: stacked keyframe measurements → ``KeyframeInput``,
  with the GNSS epochs bound to the keyframes when given.
* ``gnss_kf_from_numpy`` / ``state_ddt_from_numpy``: a ``GnssKfData`` and a
  ``WindowStateDdt`` with numpy leaves → tensors.
* ``carry_from_numpy`` / ``carry_to_numpy``: the replay carry, as
  ``replay_from`` takes it, with its IMU, GNSS-epoch and clock-drift rings,
  for checkpoint and resume.
* ``gnss_from_numpy``: GNSS epochs with numpy leaves → ``GnssEpochs``.
* ``batch_problem_from_numpy``: a batch problem with numpy leaves (a JAX
  ``BatchProblem`` through ``jax.tree.map(np.asarray, prob)``) →
  ``models.batch.BatchProblem`` on a device.
* ``odom_carry_from_numpy`` / ``odom_carry_to_numpy``: the LiDAR odometry's
  carry (``OdomCarry``), the state ``LidarOdometry.step`` takes from one
  frame to the next. The front end has no weights; its configuration goes
  through ``config_from_glio``.
"""

import dataclasses

import numpy as np
import torch

from . import config
from .models.sliding_window import (GnssKfData, KeyframeInput, ReplayCarry,
                                    SlidingWindowCarry, WindowStateDdt, gnss_from_bound)
from .solver.manifold import WindowState


def config_from_glio(cfg) -> config.GlioConfig:
    """The port's ``GlioConfig`` with every field of a ``glio_tpu`` one."""
    sections = dataclasses.asdict(cfg)
    return config.GlioConfig(**{
        f.name: f.type(**sections[f.name])
        for f in dataclasses.fields(config.GlioConfig)})


def inputs_from_numpy(imu_acc, imu_gyr, imu_dt, imu_valid, scan, scan_valid,
                      time, *, device, gnss=None) -> KeyframeInput:
    """Stacked (T, ...) numpy measurements → ``KeyframeInput`` on ``device``:
    IMU data and times f64, scans f32, masks bool. ``gnss``: the dict of
    ``gnss.dd.bind_epochs_to_keyframes``, or None for inputs without it."""
    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)
    return KeyframeInput(
        imu_acc=t(imu_acc, torch.float64), imu_gyr=t(imu_gyr, torch.float64),
        imu_dt=t(imu_dt, torch.float64), imu_valid=t(imu_valid, torch.bool),
        scan=t(scan, torch.float32), scan_valid=t(scan_valid, torch.bool),
        time=t(time, torch.float64),
        gnss=None if gnss is None else gnss_from_bound(gnss, device))


def gnss_kf_from_numpy(tree, device) -> GnssKfData:
    """A ``GnssKfData`` with numpy leaves (JAX's, through
    ``jax.tree.map(np.asarray, ...)``) → tensors on ``device``."""
    return gnss_from_bound({"gnss_" + f: getattr(tree, f) for f in GnssKfData._fields},
                           device)


def state_ddt_from_numpy(tree, device) -> WindowStateDdt:
    """A ``WindowStateDdt`` with numpy leaves → tensors on ``device``."""
    return WindowStateDdt(_tensors(WindowState, tree.win, device),
                          torch.as_tensor(np.array(tree.ddt), device=device))


def _tensors(cls, tree, device):
    return cls(**{f: torch.as_tensor(np.array(getattr(tree, f)), device=device)
                  for f in cls._fields})


def carry_from_numpy(tree, device) -> ReplayCarry:
    """A replay carry with numpy leaves and the JAX carry's field names
    (``base.window.p``, ..., ``imu_seed``, ``gnss_win``, ``ddt``) → a
    ``ReplayCarry`` on ``device``."""
    b = tree.base
    base = {f: torch.as_tensor(np.array(getattr(b, f)), device=device)
            for f in SlidingWindowCarry._fields
            if f not in ("window", "prior_lin")}
    base["window"] = _tensors(WindowState, b.window, device)
    base["prior_lin"] = _tensors(WindowState, b.prior_lin, device)
    rings = {f: torch.as_tensor(np.array(getattr(tree, f)), device=device)
             for f in ReplayCarry._fields if f not in ("base", "gnss_win")}
    return ReplayCarry(base=SlidingWindowCarry(**base),
                       gnss_win=gnss_kf_from_numpy(tree.gnss_win, device), **rings)


def carry_to_numpy(carry: ReplayCarry) -> ReplayCarry:
    """The same structure with numpy leaves (for saving a checkpoint)."""
    def conv(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return type(x)(*(conv(a) for a in x))
    return conv(carry)


def gnss_from_numpy(g):
    """GNSS epochs with the ``GnssEpochs`` field names and numpy leaves →
    the port's ``GnssEpochs`` (host numpy, as the batch stage reads it)."""
    from .data.episode import GnssEpochs
    return GnssEpochs(**{
        f.name: (None if getattr(g, f.name, None) is None
                 else np.asarray(getattr(g, f.name)))
        for f in dataclasses.fields(GnssEpochs)})


def batch_problem_from_numpy(prob, device):
    """A batch problem with numpy leaves → ``BatchProblem`` on ``device``:
    floats f64, masks bool, ``system`` int32, indices int64."""
    from .models.batch import BatchProblem
    dtypes = {"rel_valid": torch.bool, "ep_valid": torch.bool,
              "sv_valid": torch.bool, "system": torch.int32,
              "ep_left": torch.int64, "master": torch.int64}
    return BatchProblem(**{
        f: torch.as_tensor(np.array(getattr(prob, f)), device=device).to(
            dtypes.get(f, torch.float64))
        for f in BatchProblem._fields})


def odom_carry_from_numpy(tree, device):
    """An odometry carry with numpy leaves and the JAX ``OdomCarry``'s field
    names → the port's ``OdomCarry`` on ``device``."""
    from .models.lidar_odometry import OdomCarry
    return _tensors(OdomCarry, tree, device)


def odom_carry_to_numpy(carry):
    """The same structure with numpy leaves."""
    return type(carry)(*(a.detach().cpu().numpy() for a in carry))
