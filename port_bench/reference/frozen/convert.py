"""``inputs_from_numpy`` of the port's ``convert.py``: stacked keyframe
measurements → ``KeyframeInput``."""

import numpy as np
import torch

from . import precision as P
from .models.sliding_window import KeyframeInput, gnss_from_bound


def inputs_from_numpy(imu_acc, imu_gyr, imu_dt, imu_valid, scan, scan_valid,
                      time, *, device, gnss=None) -> KeyframeInput:
    """Stacked (T, ...) numpy measurements → ``KeyframeInput`` on ``device``:
    IMU data and times f64, scans f32, masks bool. ``gnss``: the dict of
    ``gnss.dd.bind_epochs_to_keyframes``, or None for inputs without it."""
    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)
    return KeyframeInput(
        imu_acc=t(imu_acc, P.F64), imu_gyr=t(imu_gyr, P.F64),
        imu_dt=t(imu_dt, P.F64), imu_valid=t(imu_valid, torch.bool),
        scan=t(scan, torch.float32), scan_valid=t(scan_valid, torch.bool),
        time=t(time, P.F64),
        gnss=None if gnss is None else gnss_from_bound(gnss, device))
