"""Where the port's LiDAR odometry spends its time, on one GPU.

    python3 scripts/profile_torch_odometry.py

Runs ``glio_tpu_torch``'s preprocessing and odometry at the raw-input
configuration of ``chip_smoke.py`` (``testing.raw_config``: 2048-point surf
clouds, a 16,384-point map, 20-frame ring, 12 LM iterations) over the first
10 frames of its HDL-32E drive (``testing.RAW_DRIVE``) on ``cuda:0``, and
reports, per frame:

* the wall time of each part of ``LidarOdometry.step`` (the map's voxel
  grid, the kNN, the plane fits, the LM solves, the rest), each part closed
  by ``torch.cuda.synchronize()`` so its time is its own, over frames 4-7;
* from ``torch.profiler`` over frames 8-9, run without those syncs: the
  device's busy share of the wall time, kernel launches per frame, and the
  kernels that take the most device time.

Prints the record as one JSON object, then the top kernels one per line.
"""

import collections
import functools
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from glio_tpu_torch import config as config_mod  # noqa: E402
from glio_tpu_torch.lidar import neighbors, plane_fit  # noqa: E402
from glio_tpu_torch.models import lidar_odometry as lo  # noqa: E402
from glio_tpu_torch.models.preprocessing import make_preprocessor  # noqa: E402
from glio_tpu_torch.solver import dense  # noqa: E402
from glio_tpu_torch.testing import RAW_DRIVE, raw_config, raw_drive  # noqa: E402

FRAMES = 10         # parts timed over frames 4-7, profiler over 8-9
TIMED = range(4, 8)
PARTS = collections.defaultdict(float)


def _timed(name, fn):
    @functools.wraps(fn)
    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        PARTS[name] += time.perf_counter() - t0
        return out
    return wrapper


def _instrument():
    """Wrap each part where the odometry looks it up; returns a function
    that removes the wrappers."""
    targets = [(neighbors, "voxel_downsample"), (lo, "knn"), (plane_fit, "fit_planes"),
               (dense, "lm_solve")]
    saved = [(obj, name, getattr(obj, name)) for obj, name in targets]
    for obj, name, fn in saved:
        setattr(obj, name, _timed(name, fn))

    def restore():
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    return restore


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_odometry: needs a CUDA device")
    dev = torch.device("cuda:0")
    cfg = raw_config(config_mod)
    _, frames, valid = raw_drive(dict(RAW_DRIVE, n_frames=FRAMES), workers=8)
    pre = make_preprocessor(cfg, dev, surf_out=cfg.shapes.scan_points)
    feats = [pre(torch.from_numpy(f), torch.from_numpy(v)) for f, v in zip(frames, valid)]
    scans = torch.stack([f.surf for f in feats])
    scans_valid = torch.stack([f.surf_valid for f in feats])
    odo = lo.make_odometry(cfg, dev)
    odo(scans, scans_valid)                                   # warm-up
    torch.cuda.synchronize()

    carry = odo.initial_carry()
    step_s = 0.0
    restore = _instrument()
    try:
        for t in range(TIMED.stop):
            if t == TIMED.start:
                PARTS.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carry, _ = odo.step(carry, scans[t], scans_valid[t])
            torch.cuda.synchronize()
            if t in TIMED:
                step_s += time.perf_counter() - t0
    finally:
        restore()
    per_frame = {k: 1e3 * v / len(TIMED) for k, v in PARTS.items()}
    per_frame["step_total"] = 1e3 * step_s / len(TIMED)
    per_frame["other"] = per_frame["step_total"] - sum(
        v for k, v in per_frame.items() if k != "step_total")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    profiled = FRAMES - TIMED.stop
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for t in range(TIMED.stop, FRAMES):
            carry, _ = odo.step(carry, scans[t], scans_valid[t])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.device_time_total
    top = [{"kernel": n[:120], "device_ms_per_frame": us / 1e3 / profiled}
           for n, us in by_name.most_common(10)]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    record = {
        "device": torch.cuda.get_device_name(dev),
        "nvidia_smi": smi.splitlines()[0],
        "part_ms_per_frame": per_frame,
        "profiled_frames": profiled,
        "profiled_wall_ms_per_frame": 1e3 * wall_s / profiled,
        "device_busy_ms_per_frame": busy_us / 1e3 / profiled,
        "device_busy_share": busy_us / 1e6 / wall_s,
        "kernel_launches_per_frame": len(kernels) / profiled,
        "top_kernels": top,
    }
    print(json.dumps(record))
    for row in top:
        print(f"{row['device_ms_per_frame']:9.3f} ms/frame  {row['kernel']}")


if __name__ == "__main__":
    main()
