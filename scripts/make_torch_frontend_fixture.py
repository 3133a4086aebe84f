"""JAX fixture for the PyTorch port's raw-input path: a ROS1 bag of a
simulated HDL-32E drive through ingest, the LiDAR front end and stage 1.

Makes the drive ``glio_tpu_torch.testing.RAW_DRIVE`` (20 frames of 32 × 1800
raycast range images at 10 Hz along ``simulate_episode(seed=8,
circle_omega=0.12)``, in a corridor of 300 walls; the port's copy of the
simulator, which ``tests/test_torch_config_data.py`` holds bit-equal to the
JAX package's), writes it with the IMU stream into a bz2 bag through
``glio_tpu_torch.testing.write_raw_bag``, and runs ``glio_tpu``'s
``episode_from_rosbag`` on it (n_cols 1800) with the configuration of
``scripts/full_pipeline_tpu.py:101-114`` (2048-point scans, 16,384-point
map, window map width 50, 15 LM iterations, 300 features with
``diverse_select``, the default 32-line odometry). It writes
``tests/data/frontend_hdl32_seed8.npz``:

* ``frames_sha256``: the frames' digest, so a check can see it rebuilt them;
* every frame's surf cloud and mask, the odometry's poses, relatives,
  keyframe flags and ``n_matches``;
* the ``Episode`` (IMU bins, ``q0``, ``acc0``, ``gyr0``, the dense channel);
* stage 1: ``make_replay``'s p, q and ``n_lidar_factors`` and
  ``run_pipeline``'s ``tc_sw_result.csv`` rows;
* JAX's own spread: the odometry (poses, relatives, ``n_matches``) rerun
  from p0 nudged by ±1e-9 m and by ±1e-5 m (the f32 resolution of the
  map's world points, which the f32 plane fits see), and stage 1 replayed
  from the episode's p0 nudged by ±1e-9 m.

About five minutes on the CPU:

    JAX_PLATFORMS=cpu python scripts/make_torch_frontend_fixture.py
"""

import contextlib
import dataclasses
import io
import json
import os
import sys
import tempfile
import time
import unittest.mock

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from glio_tpu_torch.testing import (RAW_DRIVE, frames_digest, raw_config,  # noqa: E402
                                    raw_drive, write_raw_bag)

OUT = os.path.join(ROOT, "tests", "data", "frontend_hdl32_seed8.npz")
N_COLS = 1800
NUDGES_M = (1e-9, -1e-9, 1e-5, -1e-5)


def _spread(runs, base, key):
    return max(float(np.abs(np.asarray(getattr(r, key)) - np.asarray(getattr(base, key))).max())
               for r in runs)


def make_fixture() -> dict:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from glio_tpu import config as jcfg
    from glio_tpu import pipeline as jpipe
    from glio_tpu.data import ingest
    from glio_tpu.models import lidar_odometry, preprocessing
    from glio_tpu.models.sliding_window import make_replay

    cfg = raw_config(jcfg)
    sc = dict(RAW_DRIVE)
    t0 = time.perf_counter()
    drive, frames, valid = raw_drive(sc, workers=4)
    print(f"raycast {sc['n_frames']} frames: {time.perf_counter() - t0:.1f} s", flush=True)

    # Record the surf clouds and the odometry's outputs on the way through
    # JAX's own episode_from_rosbag.
    surfs, odo = [], {}
    make_pre, make_odo = preprocessing.make_preprocessor, lidar_odometry.make_odometry

    def recording_pre(*a, **kw):
        process = make_pre(*a, **kw)

        def run(*args):
            out = process(*args)
            surfs.append((np.asarray(out.surf), np.asarray(out.surf_valid)))
            return out
        return run

    def recording_odo(*a, **kw):
        run_odo = make_odo(*a, **kw)

        def run(*args):
            odo["out"] = run_odo(*args)
            odo["run"], odo["args"] = run_odo, args
            return odo["out"]
        return run

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "drive.bag")
        write_raw_bag(path, drive, frames, valid, sc["t0"])
        t0 = time.perf_counter()
        with unittest.mock.patch.object(preprocessing, "make_preprocessor", recording_pre), \
                unittest.mock.patch.object(lidar_odometry, "make_odometry", recording_odo):
            ep = ingest.episode_from_rosbag(path, cfg, n_cols=N_COLS)
        print(f"JAX episode_from_rosbag: {time.perf_counter() - t0:.1f} s, "
              f"{ep.kf_time.shape[0]} keyframes", flush=True)
    out = odo["out"]
    scans, scans_valid = odo["args"]
    nudged = [odo["run"](scans, scans_valid, np.full(3, n), None) for n in NUDGES_M]
    small, large = nudged[:2], nudged[2:]

    replay, _ = make_replay(cfg)
    args = (ep.to_inputs(), ep.p0, ep.q0, ep.v0, ep.acc0, ep.gyr0)
    sw = replay(*args)
    sw_nudged = [replay(args[0], ep.p0 + n, *args[2:]) for n in NUDGES_M[:2]]
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
        jpipe.run_pipeline(ep, cfg, out_dir=tmp)
        rows = np.loadtxt(os.path.join(tmp, "tc_sw_result.csv"), delimiter=",", ndmin=2)
    nm = np.asarray(out.n_matches)
    fx = {
        "scenario_json": np.array(json.dumps(sc)),
        "config_json": np.array(json.dumps(dataclasses.asdict(cfg))),
        "n_cols": np.array(N_COLS),
        "frames_sha256": np.array(frames_digest(frames, valid)),
        "surf": np.stack([s for s, _ in surfs]), "surf_valid": np.stack([v for _, v in surfs]),
        "odo_p": np.asarray(out.p), "odo_q": np.asarray(out.q),
        "odo_rel_p": np.asarray(out.rel_p), "odo_rel_q": np.asarray(out.rel_q),
        "is_keyframe": np.asarray(out.is_keyframe), "n_matches": nm,
        "nudge_n_matches": np.stack([np.asarray(r.n_matches) for r in nudged]),
        "sw_p": np.asarray(sw.p), "sw_q": np.asarray(sw.q),
        "n_lidar_factors": np.asarray(sw.n_lidar_factors), "tc_sw_result": rows,
        "sw_nudge_dp": np.array(_spread(sw_nudged, sw, "p")),
        "sw_nudge_dq": np.array(_spread(sw_nudged, sw, "q")),
        "sw_nudge_nlf_equal": np.array(all(np.array_equal(np.asarray(r.n_lidar_factors),
                                                          np.asarray(sw.n_lidar_factors))
                                           for r in sw_nudged)),
    }
    for tag, runs in (("9", small), ("5", large)):
        for key in ("p", "q", "rel_p", "rel_q"):
            fx[f"odo_nudge{tag}_d{key}"] = np.array(_spread(runs, out, key))
    for f in ("kf_time", "imu_acc", "imu_gyr", "imu_dt", "imu_valid", "p0", "q0", "v0", "acc0",
              "gyr0", "dense_rel_dp", "dense_rel_dq", "dense_rel_valid", "dense_time"):
        fx["ep_" + f] = np.asarray(getattr(ep, f))
    return fx


def main():
    t0 = time.perf_counter()
    fx = make_fixture()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **fx)
    nm = fx["n_matches"]
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes) in {time.perf_counter() - t0:.0f} s: "
          f"{int(fx['is_keyframe'].sum())} keyframes of {nm.shape[0]} frames; surf points "
          f"{fx['surf_valid'].sum(1).tolist()}; n_matches {nm.tolist()} (nudged runs differ at "
          f"{int((fx['nudge_n_matches'] != nm).any(0).sum())} frames); odometry spread under "
          f"+-1e-9 m {float(fx['odo_nudge9_dp']):.3e} m, under +-1e-5 m "
          f"{float(fx['odo_nudge5_dp']):.3e} m; stage 1 n_lidar_factors "
          f"{fx['n_lidar_factors'].tolist()}, spread under +-1e-9 m "
          f"{float(fx['sw_nudge_dp']):.3e} m (n_lidar_factors "
          f"{'unchanged' if fx['sw_nudge_nlf_equal'] else 'changed'})")


if __name__ == "__main__":
    main()
