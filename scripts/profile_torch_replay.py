"""Where the port's sliding-window step spends its time, on one GPU.

    python3 scripts/profile_torch_replay.py

Runs ``glio_tpu_torch``'s replay at the ``bench.py`` shapes
(``chip_smoke.bench_config``) over 12 keyframes on ``cuda:0`` and reports,
per keyframe:

* the wall time of each phase of ``SlidingWindowEstimator.step``
  (preintegration, voxel grid, association, LM, marginalization, the rest),
  each phase closed by ``torch.cuda.synchronize()`` so its time is its own;
* from ``torch.profiler`` over the last two keyframes, run without
  those syncs: the device's busy share of the wall time, kernel
  launches per keyframe, and the kernels that take the most device time.

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

from chip_smoke import bench_config  # noqa: E402
from glio_tpu_torch.data.simulator import simulate_episode  # noqa: E402
from glio_tpu_torch.factors import imu  # noqa: E402
from glio_tpu_torch.lidar import neighbors  # noqa: E402
from glio_tpu_torch.models import sliding_window as sw  # noqa: E402
from glio_tpu_torch.solver import dense  # noqa: E402

KEYFRAMES = 12      # phases timed over keyframes 5-9, profiler over 10-11
PROFILED = 2
PHASES = collections.defaultdict(float)


def _timed(name, fn):
    @functools.wraps(fn)
    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        PHASES[name] += time.perf_counter() - t0
        return out
    return wrapper


def _instrument():
    """Wrap each phase; returns a function that removes the wrappers."""
    targets = [(imu, "preintegrate"), (imu, "sqrt_info"),
               (neighbors, "voxel_downsample"), (dense, "lm_solve"),
               (sw.SlidingWindowEstimator, "_associate"),
               (sw.SlidingWindowEstimator, "_marginalize_oldest")]
    saved = [(obj, name, getattr(obj, name)) for obj, name in targets]
    for obj, name, fn in saved:
        setattr(obj, name, _timed(name, fn))

    def restore():
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    return restore


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_replay: needs a CUDA device")
    dev = torch.device("cuda:0")
    cfg = bench_config()
    T = KEYFRAMES
    ep = simulate_episode(n_keyframes=T, scan_points=1024, seed=0)
    inputs = ep.to_inputs(dev)
    est = sw.SlidingWindowEstimator(cfg, dev)
    est.replay(inputs, ep.p0, ep.q0, ep.v0, ep.acc0, ep.gyr0)       # warm-up
    torch.cuda.synchronize()

    # Phase times, every phase closed by a sync; keyframes from 5 on (the
    # window is full and marginalization runs).
    n_timed = T - PROFILED
    carry = est.make_initial_carry(ep.p0, ep.q0, ep.v0, ep.acc0, ep.gyr0,
                                   n_imu=inputs.imu_acc.shape[-2])
    step_s = 0.0
    restore = _instrument()
    try:
        for t in range(n_timed):
            if t == 5:
                PHASES.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carry, _ = est.step(carry, sw.index_inputs(inputs, t))
            torch.cuda.synchronize()
            if t >= 5:
                step_s += time.perf_counter() - t0
    finally:
        restore()
    timed_phases = dict(PHASES)
    n_steady = n_timed - 5
    per_kf = {k: 1e3 * v / n_steady for k, v in timed_phases.items()}
    per_kf["step_total"] = 1e3 * step_s / n_steady
    per_kf["other"] = per_kf["step_total"] - sum(
        v for k, v in per_kf.items() if k != "step_total")

    # Profiler window over the remaining keyframes, no syncs inside.
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for t in range(n_timed, T):
            carry, _ = est.step(carry, sw.index_inputs(inputs, t))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.device_time_total
    top = [{"kernel": n[:120], "device_ms_per_kf": us / 1e3 / PROFILED}
           for n, us in by_name.most_common(12)]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    record = {
        "device": torch.cuda.get_device_name(dev),
        "nvidia_smi": smi.splitlines()[0],
        "phase_ms_per_keyframe": per_kf,
        "profiled_keyframes": PROFILED,
        "profiled_wall_ms_per_kf": 1e3 * wall_s / PROFILED,
        "device_busy_ms_per_kf": busy_us / 1e3 / PROFILED,
        "device_busy_share": busy_us / 1e6 / wall_s,
        "kernel_launches_per_kf": len(kernels) / PROFILED,
        "top_kernels": top,
    }
    print(json.dumps(record))
    for row in top:
        print(f"{row['device_ms_per_kf']:9.3f} ms/kf  {row['kernel']}")


if __name__ == "__main__":
    main()
