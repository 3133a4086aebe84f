"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``glio_tpu_torch``'s main path, the sliding-window replay, at the
``bench.py`` shapes on ``cuda:0`` and checks it. Phases, each of which
raises on failure:

1. device: the card's name and power limit (``nvidia-smi``); CUDA must be
   available, there is no CPU mode; TF32 off;
2. build: every CUDA kernel of the package, from the sources in the
   checkout (``nvcc``, sm_90a);
3. kernels against their plain torch versions on the card, on the same
   inputs, bit for bit: the 5-NN at the window association's shape
   (5120 queries, 16,384 map points, coordinates ~300 m from the origin,
   ~10 % invalid on each side) and two ragged cases; kernel and plain times
   by CUDA events, median of 20; then the voxel grid on the card against
   the CPU on one 51,200-point map ring;
4. replay: the 30-keyframe ``simulate_episode(seed=0)`` through
   ``SlidingWindowEstimator.replay``, once to warm up and once timed; the
   kernel must have launched once per keyframe, every output must be
   finite, and the trajectory must match the JAX package's
   (``tests/data/sw_replay_w50_seed0.npz``, made by
   ``scripts/make_torch_port_fixture.py``): n_lidar_factors equal at every
   step, max |p - p_jax| <= 5e-3 m, about 10x the JAX replay's own
   sensitivity to a 1e-9 m nudge of its start (3.8e-4 m at keyframe 30).

The line before the last is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from glio_tpu_torch.config import EstimatorConfig, GlioConfig, ShapeConfig
from glio_tpu_torch.data.simulator import simulate_episode
from glio_tpu_torch.lidar import neighbors
from glio_tpu_torch.models.sliding_window import SlidingWindowEstimator
from glio_tpu_torch.ops import _build
from glio_tpu_torch.ops import knn as knn_mod

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "data", "sw_replay_w50_seed0.npz")
N_KEYFRAMES = 30
P_TOL_M = 5e-3
F32 = np.float32


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def device_phase():
    check(torch.cuda.is_available(), "CUDA is not available; this script runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    print(f"device: {torch.cuda.get_device_name(dev)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible")
    return dev


def _cloud(rng, n, valid_share=0.9):
    pts = (rng.uniform(-40.0, 40.0, size=(n, 3)) + [300.0, -80.0, 2.0]).astype(F32)
    return pts, rng.uniform(size=n) < valid_share


def _time_ms(fn, reps=20):
    """Median of ``reps`` single launches, CUDA events, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_phase(dev):
    rng = np.random.default_rng(0)
    cases = {
        "main_path_5120x16384": (*_cloud(rng, 5120), *_cloud(rng, 16384)),
        "ragged_77x1000": (*_cloud(rng, 77), *_cloud(rng, 1000)),
        "fewer_valid_than_k": (*_cloud(rng, 300), *_cloud(rng, 64, valid_share=0.05)),
    }
    max_err = 0.0
    for name, arrays in cases.items():
        args = [torch.tensor(a, device=dev) for a in arrays]
        d_k, i_k = knn_mod.knn(*args)
        d_r, i_r = knn_mod.knn_reference(*args)
        torch.cuda.synchronize()
        check(torch.equal(i_k, i_r), f"knn {name}: kernel and plain indices differ")
        check(torch.equal(d_k, d_r), f"knn {name}: kernel and plain distances differ")
        fin = torch.isfinite(d_r)
        err = float((d_k[fin] - d_r[fin]).abs().max()) if fin.any() else 0.0
        max_err = max(max_err, err)
        print(f"knn {name}: kernel == plain (idx identical, max |d2 diff| {err}); "
              f"{int(fin.sum())} of {fin.numel()} slots filled")
    main = [torch.tensor(a, device=dev) for a in cases["main_path_5120x16384"]]
    ms = _time_ms(lambda: knn_mod.knn(*main))
    plain_ms = _time_ms(lambda: knn_mod.knn_reference(*main))
    print(f"knn 5120x16384 k=5: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms "
          f"(median of 20, CUDA events)")

    pts, valid = _cloud(rng, 51200)
    out_c, v_c = neighbors.voxel_downsample(torch.tensor(pts), torch.tensor(valid),
                                            0.4, 16384, scatter_keys=True)
    out_g, v_g = neighbors.voxel_downsample(torch.tensor(pts, device=dev),
                                            torch.tensor(valid, device=dev),
                                            0.4, 16384, scatter_keys=True)
    check(torch.equal(v_g.cpu(), v_c) and torch.equal(out_g.cpu(), out_c),
          "voxel_downsample differs between the card and the CPU")
    print(f"voxel_downsample 51200 -> 16384: card == CPU ({int(v_c.sum())} kept)")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def bench_config():
    return GlioConfig().replace(
        shapes=ShapeConfig(max_imu_per_interval=40, scan_points=1024, map_points=16384),
        estimator=EstimatorConfig(local_map_width=50, sw_max_iter=15))


def replay_phase(dev):
    cfg = bench_config()
    fx = np.load(FIXTURE)
    check(json.loads(str(fx["config_json"])) == json.loads(json.dumps(dataclasses.asdict(cfg))),
          "the fixture was made with another configuration")
    ep = simulate_episode(n_keyframes=N_KEYFRAMES, scan_points=1024, seed=0)
    est = SlidingWindowEstimator(cfg, dev)
    inputs = ep.to_inputs(dev)
    args = (inputs, ep.p0, ep.q0, ep.v0, ep.acc0, ep.gyr0)

    t0 = time.perf_counter()
    est.replay(*args)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    knn_mod.knn.launches = 0
    t0 = time.perf_counter()
    out = est.replay(*args)
    torch.cuda.synchronize()
    ms_per_kf = 1e3 * (time.perf_counter() - t0) / N_KEYFRAMES
    launches = knn_mod.knn.launches

    check(launches == N_KEYFRAMES,
          f"knn kernel launched {launches} times in {N_KEYFRAMES} keyframes")
    for f in out._fields:
        check(bool(torch.isfinite(getattr(out, f).double()).all()), f"replay output {f} not finite")
    check(tuple(out.p.shape) == (N_KEYFRAMES, 3), f"replay p has shape {tuple(out.p.shape)}")
    nlf = out.n_lidar_factors.cpu().numpy()
    check(np.array_equal(nlf, fx["n_lidar_factors"]),
          f"n_lidar_factors {nlf.tolist()} != JAX {fx['n_lidar_factors'].tolist()}")
    dp = np.abs(out.p.cpu().numpy() - fx["p"]).max(axis=1)
    dq = np.abs(out.q.cpu().numpy() - fx["q"]).max()
    check(dp.max() <= P_TOL_M, f"max |p - p_jax| = {dp.max()} m > {P_TOL_M} m")
    gt_err = np.linalg.norm(out.p.cpu().numpy() - ep.gt_p, axis=1)
    print(f"replay {N_KEYFRAMES} keyframes (width 50, scan 1024, map 16384, 15 LM iters): "
          f"{ms_per_kf:.2f} ms per keyframe (warm-up run {warm_s:.1f} s); "
          f"knn launches {launches}")
    print(f"replay vs JAX fixture: n_lidar_factors equal at all {N_KEYFRAMES} steps; "
          f"max |dp| {dp.max():.3e} m (keyframe {int(dp.argmax())}), max |dq| {dq:.3e}; "
          f"error vs ground truth at the last keyframe {gt_err[-1]:.3f} m")
    return launches


def main():
    dev = device_phase()
    print(f"build: {_build.build_all():.1f} s")
    kern = kernel_phase(dev)
    launches = replay_phase(dev)
    print(json.dumps({"kernels": [{
        "name": "knn5_f32", "route": "cuda", "source": "glio_tpu_torch/csrc/knn.cu",
        "replaces": "glio_tpu/ops/knn_pallas.py:30", "launches": launches, **kern}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
