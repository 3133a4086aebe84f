"""Point-cloud map export (port of ``glio_tpu/eval/pointcloud.py``): the
reference's ``save_pcd`` with ``mapping_interval`` (Estimator.cpp:5324-5349).
``write_pcd`` and ``read_pcd`` are host numpy; ``assemble_map`` places the
scans on ``device``."""

import numpy as np
import torch

from ..factors.lidar import body_from_lidar
from ..utils import quat


def write_pcd(path: str, points, valid=None) -> int:
    """Write an ASCII PCD v0.7 file. Returns the number of points written."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    if valid is not None:
        pts = pts[np.asarray(valid).reshape(-1)]
    n = pts.shape[0]
    with open(path, "w") as f:
        f.write(
            "# .PCD v0.7 - Point Cloud Data file format\n"
            "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
            f"COUNT 1 1 1\nWIDTH {n}\nHEIGHT 1\n"
            "VIEWPOINT 0 0 0 1 0 0 0\n"
            f"POINTS {n}\nDATA ascii\n")
        np.savetxt(f, pts, fmt="%.4f")
    return n


def read_pcd(path: str) -> np.ndarray:
    """Read an ASCII xyz PCD written by ``write_pcd``."""
    with open(path) as f:
        lines = f.readlines()
    start = next(i for i, line in enumerate(lines) if line.startswith("DATA")) + 1
    return np.loadtxt(lines[start:], dtype=np.float32).reshape(-1, 3)


def assemble_map(scans, scan_valid, p, q, every: int = 3, ql2b=(1.0, 0.0, 0.0, 0.0),
                 tl2b=(0.0, 0.0, 0.0), *, device):
    """World-frame map cloud of every ``every``-th keyframe: lidar-frame
    ``scans`` (T, S, 3) through the lidar→body extrinsic (``body_from_lidar``)
    and the poses p (T, 3), q (T, 4), in f64 on ``device``. Returns numpy
    (points (N, 3), valid (N,))."""
    def f(a):
        return torch.as_tensor(np.asarray(a, float), dtype=torch.float64, device=device)

    sel = slice(0, None, every)
    body = body_from_lidar(f(scans[sel]), f(ql2b), f(tl2b))
    world = quat.rotate(f(q[sel])[:, None, :], body) + f(p[sel])[:, None, :]
    return world.reshape(-1, 3).cpu().numpy(), np.asarray(scan_valid[sel]).reshape(-1)
