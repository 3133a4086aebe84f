"""The one traffic generator of the benchmark: drives made from a seed.

A traffic mix is a JSON file beside this module, ``<name>.json``, whose
``kind`` picks the drive it describes and whose other keys are its
parameters:

* ``window_drive``: one drive of ``simulate_episode`` (``n_keyframes`` at
  ``kf_dt``, IMU at ``imu_rate``, ``speed`` m/s, ``scan_points`` surf points a
  scan) with GNSS epochs of ``simulate_gnss_epochs`` (``gnss``: ``n_sats``,
  ``psr_noise`` m, ``epoch_stride`` keyframes).
* ``batch_drives``: ``n_drives`` drives of ``drifted_trajectory``
  (``n_keyframes``, ``max_drift`` m of odometry drift), each with its own
  GNSS epochs (``gnss`` as above) from its own seed (``seed · n_drives + i``).

Everything is numpy from the frozen simulator; the same seed gives the same
drives.
"""

from dataclasses import dataclass

import numpy as np

from ..reference.frozen.data import simulator as sim


@dataclass
class BatchDrive:
    kf_time: np.ndarray
    p_true: np.ndarray
    q_true: np.ndarray
    p_odo: np.ndarray
    gnss: object             # the frozen simulator's GnssEpochs


def window_drive(params: dict, seed: int, anchor_ecef, station_ecef):
    """The frozen simulator's ``Episode`` with its GNSS epochs attached."""
    ep = sim.simulate_episode(n_keyframes=params["n_keyframes"], kf_dt=params["kf_dt"],
                              imu_rate=params["imu_rate"], scan_points=params["scan_points"],
                              speed=params["speed"], seed=seed)
    g = params["gnss"]
    ep.anchor_ecef = np.asarray(anchor_ecef, float)
    ep.gnss = sim.simulate_gnss_epochs(ep.gt_p, ep.kf_time, ep.anchor_ecef,
                                       np.asarray(station_ecef, float), n_sats=g["n_sats"],
                                       psr_noise=g["psr_noise"], epoch_stride=g["epoch_stride"],
                                       seed=seed)
    return ep


def batch_drives(params: dict, seed: int, anchor_ecef, station_ecef) -> list:
    kf_time, p_true, q_true, p_odo = sim.drifted_trajectory(params["n_keyframes"],
                                                            params["max_drift"])
    g, n = params["gnss"], params["n_drives"]
    out = []
    for d in range(n):
        gnss = sim.simulate_gnss_epochs(p_true, kf_time, np.asarray(anchor_ecef, float),
                                        np.asarray(station_ecef, float), n_sats=g["n_sats"],
                                        psr_noise=g["psr_noise"], epoch_stride=g["epoch_stride"],
                                        seed=seed * n + d)
        out.append(BatchDrive(kf_time, p_true, q_true, p_odo, gnss))
    return out


KINDS = {"window_drive": window_drive, "batch_drives": batch_drives}


def generate(params: dict, seed: int, anchor_ecef, station_ecef):
    return KINDS[params["kind"]](params, seed, anchor_ecef, station_ecef)
