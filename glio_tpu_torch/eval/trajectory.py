"""Trajectory I/O and metrics in the reference's formats (port of ``glio_tpu/eval/trajectory.py``).

* CSV rows ``t, gps_week, gps_tow, lat, lon, alt, yaw, pitch, roll, E, N, U``
  as ``Estimator.cpp:4860-4881`` writes ``tc_sw_result.csv`` (and
  :3337-3395 the batch result);
* ATE / RPE with optional nearest-time association;
* a KML LineString of a trajectory (``write_kml``).

Host numpy, copied from the JAX package.
"""

from dataclasses import dataclass

import numpy as np

from ..utils import coords as C


@dataclass
class Trajectory:
    time: np.ndarray      # (T,) unix-GPS seconds
    llh: np.ndarray       # (T, 3) lat, lon (rad), alt (m)
    ypr_deg: np.ndarray   # (T, 3) yaw, pitch, roll (degrees)
    enu: np.ndarray       # (T, 3)

    @property
    def ecef(self):
        return C.llh2ecef_np(self.llh)


def read_result_csv(path: str) -> Trajectory:
    """Read a reference-format result CSV (lat/lon in degrees on disk)."""
    d = np.loadtxt(path, delimiter=",", ndmin=2)
    llh = np.stack([np.deg2rad(d[:, 3]), np.deg2rad(d[:, 4]), d[:, 5]], -1)
    return Trajectory(time=d[:, 0], llh=llh, ypr_deg=d[:, 6:9], enu=d[:, 9:12])


def write_result_csv(path: str, time, llh, ypr_deg, enu):
    """Write the reference's CSV row format."""
    week, tow = C.unix2gpst(np.asarray(time))
    rows = np.column_stack([
        np.asarray(time), np.asarray(week), np.asarray(tow),
        np.rad2deg(llh[:, 0]), np.rad2deg(llh[:, 1]), llh[:, 2],
        np.asarray(ypr_deg), np.asarray(enu)])
    with open(path, "w") as f:
        for r in rows:
            f.write(
                f"{r[0]:.8f},{int(r[1])},{r[2]:.8f},{r[3]:.8f},{r[4]:.8f},"
                f"{r[5]:.8f},{r[6]:.8f},{r[7]:.8f},{r[8]:.8f},"
                f"{r[9]:.8f},{r[10]:.8f},{r[11]:.8f}\n")


def associate(t_a, t_b, max_dt=0.05):
    """Nearest-time association of two stamped sequences → index pairs."""
    t_a = np.asarray(t_a)
    t_b = np.asarray(t_b)
    j = np.searchsorted(t_b, t_a)
    j = np.clip(j, 1, len(t_b) - 1)
    left = j - 1
    pick = np.where(np.abs(t_b[j] - t_a) < np.abs(t_b[left] - t_a), j, left)
    ok = np.abs(t_b[pick] - t_a) <= max_dt
    return np.nonzero(ok)[0], pick[ok]


def ate_rmse(p_est, p_ref):
    """Absolute trajectory error RMSE (no alignment: the frames are shared)."""
    e = np.linalg.norm(np.asarray(p_est) - np.asarray(p_ref), axis=-1)
    return float(np.sqrt(np.mean(e ** 2))), e


def rpe(p_est, p_ref, delta: int = 10):
    """Relative pose (translation) error over a fixed index delta."""
    d_est = p_est[delta:] - p_est[:-delta]
    d_ref = p_ref[delta:] - p_ref[:-delta]
    e = np.linalg.norm(d_est - d_ref, axis=-1)
    return float(np.sqrt(np.mean(e ** 2))), e


def write_kml(path: str, llh, name="glio_tpu trajectory"):
    """Minimal KML LineString export (nlosExclusion tooling parity)."""
    coords = " ".join(
        f"{np.rad2deg(l[1]):.9f},{np.rad2deg(l[0]):.9f},{l[2]:.3f}"
        for l in np.asarray(llh))
    with open(path, "w") as f:
        f.write(
            '<?xml version="1.0" encoding="UTF-8"?>\n'
            '<kml xmlns="http://www.opengis.net/kml/2.2"><Document>'
            f'<name>{name}</name><Placemark><LineString><coordinates>'
            f'{coords}</coordinates></LineString></Placemark>'
            '</Document></kml>\n')
