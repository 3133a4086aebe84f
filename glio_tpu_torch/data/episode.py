"""Replayable episode and GNSS epochs (port of ``glio_tpu/data/episode.py:28-139``).

All arrays are numpy on the host; ``to_inputs(device)`` stacks the
keyframe measurements into the estimator's ``KeyframeInput``: scans f32,
IMU data f64, as in the JAX package. The GNSS epochs feed the batch stage;
GNSS in the sliding window, which would bind them to keyframes here, is not
ported yet.
"""

import dataclasses
from typing import Optional

import numpy as np

from ..convert import inputs_from_numpy


@dataclasses.dataclass
class GnssEpochs:
    """Tensorized GNSS epochs with the satellite states baked in (the
    converter's output, the JAX package's ``GnssEpochs`` field for field)."""
    time: np.ndarray            # (E,) epoch times (GPS seconds as unix)
    sat_pos: np.ndarray         # (E, MAX_SV, 3) ECEF satellite positions
    sat_vel: np.ndarray         # (E, MAX_SV, 3)
    sat_ddt: np.ndarray         # (E, MAX_SV) satellite clock drift (m/s)
    psr_rov: np.ndarray         # (E, MAX_SV) raw rover pseudoranges (m)
    psr_sta: np.ndarray         # (E, MAX_SV) raw station pseudoranges (m)
    psr_rov_corr: np.ndarray    # (E, MAX_SV) corrected rover pseudoranges
    dopp_rov: np.ndarray        # (E, MAX_SV) range-rate (m/s) = −doppler·λ
    elevation: np.ndarray       # (E, MAX_SV) radians
    snr: np.ndarray             # (E, MAX_SV) dB-Hz
    valid: np.ndarray           # (E, MAX_SV) bool
    system: np.ndarray          # (E, MAX_SV) int8 constellation id (0..3)
    master: np.ndarray          # (E, 4) int32 master slot per system (−1 none)
    car_rov: Optional[np.ndarray] = None    # (E, MAX_SV) carrier (m)
    car_sta: Optional[np.ndarray] = None    # (E, MAX_SV) station carrier (m)
    car_valid: Optional[np.ndarray] = None  # (E, MAX_SV) bool
    lli: Optional[np.ndarray] = None        # (E, MAX_SV) int8 loss-of-lock
    sat_id: Optional[np.ndarray] = None     # (E, MAX_SV) int32 sys*100+prn
    station_synthesized: Optional[np.ndarray] = None  # () bool: DD built
                                            # against a synthesized base


@dataclasses.dataclass
class Episode:
    kf_time: np.ndarray         # (T,)
    # IMU runs between keyframe i-1 and i (run 0 is empty).
    imu_acc: np.ndarray         # (T, NI, 3)
    imu_gyr: np.ndarray         # (T, NI, 3)
    imu_dt: np.ndarray          # (T, NI)
    imu_valid: np.ndarray       # (T, NI) bool
    # Lidar-frame surf clouds per keyframe.
    scan: np.ndarray            # (T, S, 3) float32
    scan_valid: np.ndarray      # (T, S) bool
    # Initial state.
    p0: np.ndarray              # (3,)
    q0: np.ndarray              # (4,)
    v0: np.ndarray              # (3,)
    # IMU sample at the first keyframe time (midpoint seed for interval 1).
    acc0: Optional[np.ndarray] = None
    gyr0: Optional[np.ndarray] = None
    # Ground truth at keyframe times, where known.
    gt_p: Optional[np.ndarray] = None   # (T, 3)
    gt_q: Optional[np.ndarray] = None   # (T, 4)
    gt_v: Optional[np.ndarray] = None   # (T, 3)
    gnss: Optional[GnssEpochs] = None
    # Georeference: local ENU anchor in ECEF and the local frame's yaw
    # against ENU; None falls back to the config's values.
    anchor_ecef: Optional[np.ndarray] = None
    yaw_enu_local: Optional[float] = None
    # Dense non-key frame odometry: the local-graph interpolation's input,
    # which ``run_pipeline`` refines into ``dense_path.csv``.
    dense_rel_dp: Optional[np.ndarray] = None     # (T-1, D+1, 3)
    dense_rel_dq: Optional[np.ndarray] = None     # (T-1, D+1, 4)
    dense_rel_valid: Optional[np.ndarray] = None  # (T-1, D+1) bool
    dense_time: Optional[np.ndarray] = None       # (T-1, D)

    def to_inputs(self, device):
        """Stacked ``KeyframeInput`` on ``device``."""
        return inputs_from_numpy(self.imu_acc, self.imu_gyr, self.imu_dt,
                                 self.imu_valid, self.scan, self.scan_valid,
                                 self.kf_time, device=device)
