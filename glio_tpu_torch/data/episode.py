"""Replayable episode (port of ``glio_tpu/data/episode.py:62-139``).

All arrays are numpy on the host; ``to_inputs(device)`` stacks them into the
estimator's ``KeyframeInput``: scans f32, IMU data f64, as in the JAX
package. This slice carries no GNSS channel.
"""

import dataclasses
from typing import Optional

import numpy as np

from ..convert import inputs_from_numpy


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

    def to_inputs(self, device):
        """Stacked ``KeyframeInput`` on ``device``."""
        return inputs_from_numpy(self.imu_acc, self.imu_gyr, self.imu_dt,
                                 self.imu_valid, self.scan, self.scan_valid,
                                 self.kf_time, device=device)
