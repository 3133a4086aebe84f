"""Replayable episode and GNSS epochs (port of ``glio_tpu/data/episode.py``).

All arrays are numpy on the host; ``to_inputs(device)`` stacks the
keyframe measurements into the estimator's ``KeyframeInput``: scans f32,
IMU data f64, as in the JAX package, with the GNSS epochs bound to the
keyframes' intervals (``gnss.dd.bind_epochs_to_keyframes``; zeros without
GNSS) for GNSS in the sliding window. ``save`` / ``load`` keep an episode in
one compressed ``.npz``, the JAX package's layout.
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

    @property
    def num_keyframes(self):
        return self.kf_time.shape[0]

    def to_inputs(self, device, max_sv: int = 32):
        """Stacked ``KeyframeInput`` on ``device``, GNSS bound in ``max_sv``
        slots."""
        from ..gnss.dd import bind_epochs_to_keyframes
        return inputs_from_numpy(self.imu_acc, self.imu_gyr, self.imu_dt,
                                 self.imu_valid, self.scan, self.scan_valid,
                                 self.kf_time, device=device,
                                 gnss=bind_epochs_to_keyframes(self.gnss, self.kf_time, max_sv))

    def save(self, path: str):
        """Every field that is set, GNSS fields under ``gnss.``, in one
        compressed ``.npz``."""
        flat = {}

        def add(prefix, d):
            for k, v in d.items():
                if isinstance(v, dict):
                    add(f"{prefix}{k}.", v)
                elif v is not None:
                    flat[f"{prefix}{k}"] = np.asarray(v)

        add("", dataclasses.asdict(self))
        np.savez_compressed(path, **flat)

    @staticmethod
    def load(path: str) -> "Episode":
        z = np.load(path)
        gnss_keys = [k for k in z.files if k.startswith("gnss.")]
        gnss = None
        if gnss_keys:
            gnss = GnssEpochs(**{k.split(".", 1)[1]: z[k] for k in gnss_keys})
        kwargs = {k: z[k] for k in z.files if "." not in k}
        ep = Episode(gnss=gnss, **{k: v for k, v in kwargs.items() if k != "yaw_enu_local"})
        if "yaw_enu_local" in z.files:
            ep.yaw_enu_local = float(z["yaw_enu_local"])
        return ep
