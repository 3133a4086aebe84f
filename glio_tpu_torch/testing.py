"""Inputs and timing shared by the port's checks on the card.

``chip_smoke.py``, ``tests/test_torch_cuda.py`` and
``scripts/bench_torch_knn.py`` draw their 5-NN inputs from here (single
problems in ``KNN_CASES``, batches of keyframe pairs in ``KNN_PAIR_CASES``)
and time kernels with ``time_device_ms``, so the three agree on what a case
and a time are; ``selected_indices`` names the points level 1's
correspondences hold. The scenarios of the stage-3 fixtures
(``scripts/make_torch_stage3_fixture.py``) are built here too, from the
simulator the caller passes (the JAX package's or the port's), so the
fixture script, the CPU tests and ``chip_smoke.py`` build the same ones.
Nothing on an estimation path imports this module.
"""

import re
import statistics
import subprocess

import numpy as np
import torch

F32 = np.float32


def cloud(rng, n, valid_share=0.9, spread=40.0):
    """``n`` points uniform in a cube of half-width ``spread`` m centred
    ~300 m from the origin, where the f32 expansion of the distance cancels,
    and a validity mask with ``valid_share`` of them valid."""
    pts = (rng.uniform(-spread, spread, size=(n, 3)) + [300.0, -80.0, 2.0]).astype(F32)
    return pts, rng.uniform(size=n) < valid_share


def lattice(rng, n, valid_share=0.9):
    """Points on the integer lattice of a 9 m cube ~300 m out: every query
    of the same lattice has ~n / 729 neighbours at exactly the same
    distance, spread over every split of the map."""
    pts = (rng.integers(-4, 5, size=(n, 3)) + [300, -80, 2]).astype(F32)
    return pts, rng.uniform(size=n) < valid_share


def halves_copied(rng, n):
    """A cloud whose second half repeats its first: each point has a twin
    exactly n / 2 indices on, in another block of the kernel's cluster."""
    pts, valid = cloud(rng, n // 2)
    return np.concatenate([pts, pts]), np.concatenate([valid, valid])


# name: rng -> (query, query_valid, points, points_valid). The cluster sizes
# are knn_plan's on a 132-SM H100.
KNN_CASES = {
    # The window association: 5 x 1024 queries, 16,384 map points (1 block).
    "main_path": lambda r: (*cloud(r, 5120), *cloud(r, 16384)),
    # The odometry's ICP: a 1024- or 2048-point scan against its map (4, 2).
    "odometry_1024x16384": lambda r: (*cloud(r, 1024), *cloud(r, 16384)),
    "odometry_2048x16384": lambda r: (*cloud(r, 2048), *cloud(r, 16384)),
    "ragged": lambda r: (*cloud(r, 77), *cloud(r, 1000)),
    "fewer_valid_than_k": lambda r: (*cloud(r, 300), *cloud(r, 64, valid_share=0.05)),
    "empty_map": lambda r: (*cloud(r, 50), *cloud(r, 0)),
    "ties": lambda r: (np.zeros((3, 3), F32), np.ones(3, bool),
                       np.repeat(np.eye(3, dtype=F32), 4, axis=0), np.ones(12, bool)),
    # Exact ties and twins across 8 and 2 splits.
    "ties_across_splits": lambda r: (*lattice(r, 300), *lattice(r, 16384)),
    "twins_across_splits": lambda r: (*cloud(r, 2000), *halves_copied(r, 16384)),
    # Maps of 300 and 3 points split 8 ways; 16,381 points split 4 ways.
    "map_below_one_split": lambda r: (*cloud(r, 500), *cloud(r, 300)),
    "map_below_4_points": lambda r: (*cloud(r, 100), *cloud(r, 3, valid_share=1.0)),
    "map_not_multiple_of_split": lambda r: (*cloud(r, 1000), *cloud(r, 16381)),
    # Query counts that end in a part-filled 16-query tile.
    "queries_ragged_5119": lambda r: (*cloud(r, 5119), *cloud(r, 16384)),
    "queries_ragged_17000": lambda r: (*cloud(r, 17000), *cloud(r, 16384)),
    "all_map_points_invalid": lambda r: (*cloud(r, 1000), *cloud(r, 4096, valid_share=0.0)),
    # Loop closure's ICP: a 1024-point scan against 25 keyframes' scans (2).
    "loop_verify_1024x25600": lambda r: (*cloud(r, 1024), *cloud(r, 25600)),
}


def pair_stack(rng, frames, n, valid_share=0.9):
    """``frames`` clouds of ``n`` points each, as batch level 1 stacks its
    keyframes' world points: (F, n, 3) f32 and (F, n) bool."""
    pts, valid = cloud(rng, frames * n, valid_share, spread=20.0)
    return pts.reshape(frames, n, 3), valid.reshape(frames, n)


def random_pairs(rng, frames, count):
    """``count`` (i, j) frame pairs, int64."""
    return (rng.integers(0, frames, count).astype(np.int64),
            rng.integers(0, frames, count).astype(np.int64))


def _all_invalid_frame(r):
    world, valid = pair_stack(r, 8, 1024)
    valid[3] = False
    i, j = random_pairs(r, 8, 64)
    j[::4] = 3                               # every fourth map empty
    i[1::8] = 3                              # and some queries all invalid
    return world, valid, i, j


# name: rng -> (world, world_valid, i_idx, j_idx) for ops.knn.knn_pairs:
# batched problems over one stack of clouds, each in one launch. The
# cluster sizes are knn_plan's on a 132-SM H100.
KNN_PAIR_CASES = {
    # Level 1's shape: 1024-point keyframes, a batch of pairs (1 block).
    "pairs_256x1024": lambda r: (*pair_stack(r, 40, 1024), *random_pairs(r, 40, 256)),
    "map_all_invalid": _all_invalid_frame,
    # S = 1000: a ragged last tile, frames not 16-byte aligned.
    "ragged_1000": lambda r: (*pair_stack(r, 10, 1000), *random_pairs(r, 10, 64)),
    "ragged_1001": lambda r: (*pair_stack(r, 10, 1001), *random_pairs(r, 10, 64)),
    # One pair (cluster of 4, the map split) and two (cluster of 2).
    "one_pair": lambda r: (*pair_stack(r, 3, 1024), *random_pairs(r, 3, 1)),
    "two_pairs": lambda r: (*pair_stack(r, 3, 1024), *random_pairs(r, 3, 2)),
    # The most pairs a call takes, every row of the grid: 16-point frames.
    "max_pairs_65535": lambda r: (*pair_stack(r, 8, 16), *random_pairs(r, 8, 65535)),
}


def knn_pairs_bound_ms(world_valid, i_idx, j_idx, sms, clock_mhz):
    """``knn_bound_ms`` summed over a batch of pairs: each pair's valid
    queries times its valid map points, at 8 FP32 operations each."""
    n = world_valid.sum(dim=1).to(torch.float64)
    pairs = float(torch.sum(n[i_idx] * n[j_idx]))
    return 8 * pairs / (sms * 128 * clock_mhz * 1e6) * 1e3


def time_device_ms(fn, reps=20):
    """Median of ``reps`` single calls of ``fn``, in ms, by CUDA events,
    after one warm-up. Each call is queued behind a ~50 us device sleep, so
    the start event fires only once the host has enqueued the call, and the
    host's path to the launch is not counted."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def gpu_clock_mhz():
    """The card's maximum SM clock, MHz (``nvidia-smi``)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.split()[0])


def knn_bound_ms(query_valid, points_valid, sms, clock_mhz):
    """Least time for the 5-NN's distances on this card: the valid pairs
    at 8 FP32 operations each (3 sub, 3 mul, 2 add; no FMA), one per lane
    per cycle on sms x 128 lanes; bytes (< 1 MB) are far below it."""
    pairs = int(query_valid.sum()) * int(points_valid.sum())
    return 8 * pairs / (sms * 128 * clock_mhz * 1e6) * 1e3


def selected_indices(scans, pts_i, mask):
    """(T, R, F) uint16: the index in scan i of the point each slot of
    frame i holds (the first of equal points), 0xFFFF where the slot is
    empty; level 1's correspondences store the point, not its index.
    numpy in, numpy out."""
    scans = np.asarray(scans, np.float32).astype(np.float64)
    pts_i, mask = np.asarray(pts_i), np.asarray(mask)
    out = np.full(mask.shape, 0xFFFF, np.uint16)
    for i in range(mask.shape[0]):
        eq = np.all(pts_i[i][:, :, None, :] == scans[i][None, None], -1)   # (R, F, S)
        if not (eq.any(-1) | ~mask[i]).all():
            raise ValueError(f"frame {i}: a slot holds no point of its scan")
        out[i] = np.where(mask[i], eq.argmax(-1), 0xFFFF)
    return out


# --- scenarios of the stage-3 fixtures ----------------------------------------------

def divergence_episode(sc, simulate_episode):
    """The backend-fusion divergence scenario ``sc`` (a fixture's
    ``scenario_json``): IMU specific force offset by ``imu_bias`` on
    ``imu_bias_frames``, LiDAR blinded on ``blind_frames``."""
    ep = simulate_episode(n_keyframes=sc["n_keyframes"], scan_points=sc["scan_points"],
                          seed=sc["seed"])
    a, b = sc["imu_bias_frames"]
    ep.imu_acc[a:b] += np.asarray(sc["imu_bias"])
    a, b = sc["blind_frames"]
    ep.scan_valid[a:b] = False
    return ep


_RESET = re.compile(r"\[fusion t=(\d+)\] RESET → (fused tail|direct RTK fix)")


def reset_decisions(lines):
    """(keyframe, branch) of every reset in ``replay_with_backend_fusion``'s
    ``debug`` lines."""
    return [(int(m.group(1)), m.group(2)) for m in map(_RESET.search, lines) if m]


def loop_episode(sc, simulate_episode):
    """The loop-closure scenario ``sc``: a ``circle_omega`` drive of
    ``n_keyframes`` (a lap every ``lap_keyframes``) and its chain drifted
    smoothly, as (k/(T−1))² · ``drift``. Returns (episode, drifted p)."""
    T = sc["n_keyframes"]
    ep = simulate_episode(n_keyframes=T, kf_dt=1.0 / 3.0, scan_points=sc["scan_points"],
                          seed=sc["seed"], circle_omega=2 * np.pi / (sc["lap_keyframes"] / 3.0))
    ramp = (np.arange(T) / (T - 1))[:, None] ** 2
    return ep, ep.gt_p + ramp * np.asarray(sc["drift"])


def dense_episode(sc, simulate_episode):
    """The dense-frame scenario ``sc``: a ``dense_frames`` drive and its
    keyframe positions (truth plus N(0, ``pose_noise``) m)."""
    ep = simulate_episode(n_keyframes=sc["n_keyframes"], scan_points=sc["scan_points"],
                          seed=sc["seed"], dense_frames=sc["dense_frames"],
                          dense_noise=sc["dense_noise"])
    rng = np.random.default_rng(sc["pose_seed"])
    return ep, ep.gt_p + rng.normal(scale=sc["pose_noise"], size=ep.gt_p.shape)
