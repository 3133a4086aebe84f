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
So is the raw-input drive (``RAW_DRIVE``, ``raw_drive``): simulated 10 Hz
range images written, with the IMU stream, into a ROS1 bag by this module's
copy of the bag writer of ``tests/test_ingest.py`` (``serialize_imu``,
``serialize_pointcloud2``, ``write_bag``), which the ingest path reads.
Nothing on an estimation path imports this module.
"""

import bz2
import dataclasses
import hashlib
import multiprocessing
import re
import statistics
import struct
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
    # The window association at 2048-point scans (raw input): 5 x 2048 queries.
    "window_2048pt_10240x16384": lambda r: (*cloud(r, 10240), *cloud(r, 16384)),
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


def imu_runs(rng, lead, n=40, valid_share=1.0, garbage=False, dense_noise=False):
    """Inputs of ``factors.imu.preintegrate`` as numpy arrays: (acc, gyr,
    dt, valid, ba, bg, acc0, gyr0, noise_cov) for ``lead`` edges of ``n``
    slots of 100 Hz samples near rest (gravity plus a few m/s², turns under
    0.3 rad/s), ``valid_share`` of the slots valid at random. With
    ``garbage`` the invalid slots hold large finite values (a padded buffer
    is never cleared); with ``dense_noise`` the 18 × 18 noise block is the
    diagonal one plus a dense symmetric positive part."""
    from .factors.imu import ImuParams
    lead = tuple(lead)
    acc = rng.normal(size=lead + (n, 3)) * 2.0 + [0.0, 0.0, 9.8]
    gyr = rng.normal(size=lead + (n, 3)) * 0.1
    dt = 0.01 + rng.uniform(-5e-4, 5e-4, size=lead + (n,))
    valid = rng.uniform(size=lead + (n,)) < valid_share
    if garbage:
        acc = np.where(valid[..., None], acc, rng.normal(size=acc.shape) * 1e3)
        gyr = np.where(valid[..., None], gyr, rng.normal(size=gyr.shape) * 1e2)
        dt = np.where(valid, dt, rng.uniform(1.0, 10.0, size=dt.shape))
    noise = ImuParams().noise_cov().numpy()
    if dense_noise:
        a = rng.normal(size=(18, 18)) * 1e-3
        noise = noise + a @ a.T
    return (acc, gyr, dt, valid, rng.normal(size=lead + (3,)) * 0.05,
            rng.normal(size=lead + (3,)) * 0.005, acc[..., 0, :] + rng.normal(size=3) * 0.1,
            gyr[..., 0, :] + rng.normal(size=3) * 0.01, noise)


def _no_valid_edge(r):
    args = imu_runs(r, (3,))
    args[3][1] = False
    return args


# name: rng -> the inputs of factors.imu.preintegrate (``imu_runs``), for the
# kernel against its plain version on the card.
IMU_PREINT_CASES = {
    "window_4x40": lambda r: imu_runs(r, (4,)),            # the window's edges
    "single_40": lambda r: imu_runs(r, ()),                # no leading axis: one block
    "lead_2x3x40": lambda r: imu_runs(r, (2, 3)),
    "chain_3492x40": lambda r: imu_runs(r, (3492,)),       # the batch's IMU chain
    "scattered_invalid": lambda r: imu_runs(r, (4,), valid_share=0.6, garbage=True),
    "no_valid_edge": _no_valid_edge,
    "dense_noise": lambda r: imu_runs(r, (4,), dense_noise=True),
    # 150 slots: the kernel stages samples 64 at a time, gaps across its tiles.
    "long_3x150": lambda r: imu_runs(r, (3,), n=150, valid_share=0.5, garbage=True),
}


def knn_pairs_bound_ms(world_valid, i_idx, j_idx, sms, clock_mhz):
    """``knn_bound_ms`` summed over a batch of pairs: each pair's valid
    queries times its valid map points, at 8 FP32 operations each."""
    n = world_valid.sum(dim=1).to(torch.float64)
    pairs = float(torch.sum(n[i_idx] * n[j_idx]))
    return 8 * pairs / (sms * 128 * clock_mhz * 1e6) * 1e3


def spd_band(T, hw, D, seed=0, device="cpu"):
    """A block band (T, 2hw+1, D, D) f32 of a symmetric, diagonally dominant
    (so positive definite) matrix with unit-scale entries, for the band
    Cholesky kernels at any block size."""
    g = torch.Generator().manual_seed(seed)
    off = torch.randn((T, hw, D, D), generator=g, dtype=torch.float64) / (2 * D * hw)
    band = torch.zeros((T, 2 * hw + 1, D, D), dtype=torch.float64)
    for o in range(1, min(hw, T - 1) + 1):   # A[t][t-o] = off[t, o-1]; A[t-o][t] its transpose
        band[o:, hw - o] = off[o:, o - 1]
        band[:T - o, hw + o] = off[o:, o - 1].mT
    a = torch.randn((T, D, D), generator=g, dtype=torch.float64) / D
    band[:, hw] = 2.0 * torch.eye(D, dtype=torch.float64) + 0.1 * (a @ a.mT)
    return band.to(torch.float32).contiguous().to(device)


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


# --- raw sensor input: a ROS1 bag of a simulated drive -------------------------------
# The bag writer is a copy of ``tests/test_ingest.py``'s, byte for byte in
# what it writes (``tests/test_torch_ingest.py`` holds the two equal).

def _field(name: bytes, value: bytes) -> bytes:
    kv = name + b"=" + value
    return struct.pack("<I", len(kv)) + kv


def _record(fields, data: bytes) -> bytes:
    hdr = b"".join(_field(k, v) for k, v in fields)
    return (struct.pack("<I", len(hdr)) + hdr
            + struct.pack("<I", len(data)) + data)


def _conn_record(cid: int, topic: str, typ: str) -> bytes:
    data = (_field(b"topic", topic.encode())
            + _field(b"type", typ.encode())
            + _field(b"md5sum", b"0" * 32)
            + _field(b"message_definition", b""))
    return _record([(b"op", b"\x07"),
                    (b"conn", struct.pack("<I", cid)),
                    (b"topic", topic.encode())], data)


def _msg_record(cid: int, t: float, raw: bytes) -> bytes:
    secs = int(t)
    nsecs = int(round((t - secs) * 1e9))
    return _record([(b"op", b"\x02"),
                    (b"conn", struct.pack("<I", cid)),
                    (b"time", struct.pack("<II", secs, nsecs))], raw)


def _ros_string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def _ros_header(t: float, frame: str = "f") -> bytes:
    secs = int(t)
    nsecs = int(round((t - secs) * 1e9))
    return struct.pack("<III", 0, secs, nsecs) + _ros_string(frame)


def serialize_imu(t: float, acc, gyr) -> bytes:
    """A ``sensor_msgs/Imu`` message: identity orientation, zero covariances."""
    cov = struct.pack("<9d", *([0.0] * 9))
    return (_ros_header(t)
            + struct.pack("<4d", 0.0, 0.0, 0.0, 1.0) + cov
            + struct.pack("<3d", *gyr) + cov
            + struct.pack("<3d", *acc) + cov)


def serialize_pointcloud2(t: float, xyz: np.ndarray, ring: np.ndarray = None) -> bytes:
    """An unorganised ``sensor_msgs/PointCloud2``: x, y, z f32 and, when
    given, a uint16 ``ring`` field."""
    n = xyz.shape[0]
    fields = [("x", 0, 7), ("y", 4, 7), ("z", 8, 7)]
    step = 12
    if ring is not None:
        fields.append(("ring", 12, 4))
        step = 16
    fb = struct.pack("<I", len(fields))
    for name, off, dt in fields:
        fb += _ros_string(name) + struct.pack("<IBI", off, dt, 1)
    rec = np.zeros((n, step), np.uint8)
    rec[:, 0:12] = xyz.astype(np.float32).view(np.uint8).reshape(n, 12)
    if ring is not None:
        rec[:, 12:14] = ring.astype(np.uint16).view(np.uint8).reshape(n, 2)
    data = rec.tobytes()
    return (_ros_header(t) + struct.pack("<II", 1, n) + fb
            + b"\x00" + struct.pack("<II", step, step * n)
            + struct.pack("<I", len(data)) + data + b"\x01")


def write_bag(path, scan_msgs, imu_msgs, compress="bz2"):
    """A rosbag v2.0 file of one chunk (``bz2`` or ``none``):
    ``/velodyne_points`` and ``/imu/data``; scan_msgs / imu_msgs are lists
    of (t, raw_bytes)."""
    chunks = b"".join(
        [_msg_record(1, t, raw) for t, raw in scan_msgs]
        + [_msg_record(2, t, raw) for t, raw in imu_msgs])
    payload = bz2.compress(chunks) if compress == "bz2" else chunks
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        f.write(_record([(b"op", b"\x03"),
                         (b"index_pos", struct.pack("<Q", 0)),
                         (b"conn_count", struct.pack("<I", 2)),
                         (b"chunk_count", struct.pack("<I", 1))],
                        b" " * 64))
        f.write(_conn_record(1, "/velodyne_points", "sensor_msgs/PointCloud2"))
        f.write(_conn_record(2, "/imu/data", "sensor_msgs/Imu"))
        f.write(_record([(b"op", b"\x05"),
                         (b"compression", compress.encode()),
                         (b"size", struct.pack("<I", len(chunks)))],
                        payload))


def imu_messages(ep, t0):
    """The IMU intervals of a simulated episode as a message stream, from
    ``t0``: a pre-roll sample at the first keyframe (for gravity alignment),
    then interval i's samples at their times in (kf_time[i-1], kf_time[i]]."""
    msgs = [(t0, serialize_imu(t0, ep.acc0, ep.gyr0))]
    for i in range(1, ep.kf_time.shape[0]):
        ts = t0 + ep.kf_time[i - 1] + np.cumsum(ep.imu_dt[i])
        for j in range(int(ep.imu_valid[i].sum())):
            msgs.append((ts[j], serialize_imu(ts[j], ep.imu_acc[i, j], ep.imu_gyr[i, j])))
    return msgs


# The raw-input drive of ``chip_smoke.py`` and ``scripts/make_torch_frontend_fixture.py``:
# the HDL-32E mission of ``scripts/full_pipeline_tpu.py:36-80`` cut to 20 frames
# at 10 Hz (a keyframe drive at kf_dt 0.1 s, ~5 m/s), raycast against a corridor
# of 300 walls.
RAW_DRIVE = dict(n_frames=20, kf_dt=0.1, scan_points=2048, seed=8, scan_noise=0.01,
                 circle_omega=0.12, n_walls=300, world_seed=8, rings=32, cols=1800,
                 elev_lo=-0.535, elev_hi=0.186, max_range=80.0, raycast_seed=12,
                 t0=1000.0)


def raw_config(config_module):
    """The raw-input configuration, ``scripts/full_pipeline_tpu.py:101-114``,
    from a config module (the JAX package's or the port's): 2048-point
    scans, a 16,384-point map, window map width 50, 15 LM iterations, 300
    features with ``diverse_select``, the default 32-line odometry."""
    c = config_module
    base = c.GlioConfig()
    return base.replace(
        shapes=c.ShapeConfig(max_imu_per_interval=40, scan_points=2048, map_points=16384),
        estimator=c.EstimatorConfig(local_map_width=50, sw_max_iter=15),
        feature_selection=dataclasses.replace(base.feature_selection, feature_res_num=300,
                                              diverse_select=True))


def _raycast_frame(sc, f, world, p_w, R_wb):
    """Frame f of the drive: the shared generator, advanced past the noise
    draws of frames 0..f-1 (one normal per ray each), so that frames can be
    made in any order or process."""
    from .data.simulator import raycast_scan
    rng = np.random.default_rng(sc["raycast_seed"])
    for _ in range(f):
        rng.normal(size=sc["rings"] * sc["cols"])
    return raycast_scan(world, p_w, R_wb, n_rings=sc["rings"], n_cols=sc["cols"],
                        elev_lo=sc["elev_lo"], elev_hi=sc["elev_hi"],
                        max_range=sc["max_range"], rng=rng)


def raw_drive(sc, workers: int = 1):
    """The drive ``sc`` (``RAW_DRIVE``'s keys), from the port's copy of the
    simulator (bit-equal to the JAX package's): (episode, frames
    (N, rings, cols, 3) f32, valid (N, rings, cols)). Frame f is taken at
    keyframe f's true pose, from the IMU-rate truth; ``workers`` processes
    raycast the frames (the same frames for any count)."""
    from .data.simulator import _quat_rotmat, corridor_world, simulate_episode
    n = sc["n_frames"]
    ep, dense = simulate_episode(
        n_keyframes=n, kf_dt=sc["kf_dt"], scan_points=sc["scan_points"], seed=sc["seed"],
        scan_noise=sc["scan_noise"], q_lb=(1, 0, 0, 0), t_lb=(0, 0, 0),
        circle_omega=sc["circle_omega"], return_dense_gt=True)
    step = (dense["p"].shape[0] - 1) // n          # IMU samples per frame
    world = corridor_world(dense["p"][::step], n_walls=sc["n_walls"], seed=sc["world_seed"])
    jobs = [(sc, f, world, dense["p"][j], _quat_rotmat(dense["q"][j]))
            for f, j in enumerate(dense["kf_idx"][:n])]
    if workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(workers) as pool:
            out = pool.starmap(_raycast_frame, jobs)
    else:
        out = [_raycast_frame(*job) for job in jobs]
    frames = np.stack([img for img, _ in out])
    valid = np.stack([v for _, v in out])
    # Snap to a 2^-16 m grid (exact in f32 below 256 m): the host's BLAS
    # moves the raycast's last bits (1e-17 m on near-zero coordinates between
    # two x86 hosts), and the snapped frames are the same on any host.
    frames = np.round(frames * 65536.0) / np.float32(65536.0)
    return ep, frames, valid


def frames_digest(frames, valid):
    """sha256 of a drive's frames and masks, hex."""
    return hashlib.sha256(np.ascontiguousarray(frames).tobytes()
                          + np.ascontiguousarray(valid).tobytes()).hexdigest()


def write_raw_bag(path, ep, frames, valid, t0, compress="bz2"):
    """Frames as unorganised clouds (the valid returns, as a LiDAR
    publishes them) at their keyframe times from ``t0``, with the IMU stream."""
    scans = [(t0 + ep.kf_time[f], serialize_pointcloud2(t0 + ep.kf_time[f], frames[f][valid[f]]))
             for f in range(frames.shape[0])]
    write_bag(path, scans, imu_messages(ep, t0), compress)


# --- synthetic RINEX -------------------------------------------------------------
#
# A RINEX 3 nav file of broadcast Kepler elements chosen here and an obs file
# of a receiver along a known drive, for the GNSS input path (``gnss.rinex``,
# ``gnss.native``, ``gnss.converter``) where no recorded drive is at hand. The
# satellite states come from the port's ``gnss.ephemeris`` on the elements as
# they read back from the nav file, and every value is rounded to its field's
# decimals, so the files are text that any reader decodes the same way.

GNSS_T0 = (2021, 5, 17, 2, 0, 0)     # GPS civil time of the first epoch (a Monday)
GNSS_DRIVE = dict(n_keyframes=3493, max_drift=6.0, epoch_stride=3, epoch_offset=0.01,
                  seed=15, n_gps=8, n_bds=6, psr_noise=0.5)


def gps_unix(y, mo, d, hh, mi, ss):
    """GPS civil time → GPS seconds on the unix epoch (the converter's time)."""
    from .gnss.rinex import civil2gps
    week, tow = civil2gps(y, mo, d, hh, mi, ss)
    return 315964800.0 + week * 604800.0 + tow


def _gps_civil(t):
    """GPS seconds on the unix epoch → (y, mo, d, hh, mi, ss), the inverse of
    ``gps_unix`` (``rinex.write_obs_v2``'s calendar arithmetic)."""
    from .gnss.rinex import GPS_DAY0
    tu = t - 315964800.0
    week = int(tu // 604800.0)
    tow = tu - week * 604800.0
    mjd = GPS_DAY0 + week * 7 + int(tow // 86400.0)
    sod = tow - int(tow // 86400.0) * 86400.0
    a = mjd + 2400001 + 32044
    b = (4 * a + 3) // 146097
    c = a - 146097 * b // 4
    d = (4 * c + 3) // 1461
    e = c - 1461 * d // 4
    m = (5 * e + 2) // 153
    day = e - (153 * m + 2) // 5 + 1
    month = m + 3 - 12 * (m // 10)
    year = 100 * b + d - 4800 + m // 10
    hh = int(sod // 3600)
    mi = int((sod - hh * 3600) // 60)
    return year, month, day, hh, mi, sod - hh * 3600 - mi * 60


def _d19(v):
    """One RINEX nav field (D19.12, written with E)."""
    return f"{float(v): .12E}"


def _rounded(v):
    return float(_d19(v))


_ORBITS = {  # system char → (sqrt_a, inclination (rad)) of its medium orbits
    "G": (5153.7, 0.9599), "C": (5282.6, 0.9599)}


def _candidate(rng, sys_c, prn, geo):
    """Random broadcast elements of one satellite, each rounded to its field."""
    if geo:
        sqrt_a, i0, e = 6493.4 + rng.normal(0, 0.2), 0.08 + rng.normal(0, 0.01), 5e-4
        omega_dot = 0.0
    else:
        sqrt_a, i0 = _ORBITS[sys_c]
        sqrt_a, i0 = sqrt_a + rng.normal(0, 0.3), i0 + rng.normal(0, 0.01)
        e = rng.uniform(0.001, 0.02)
        omega_dot = -8.0e-9 + rng.normal(0, 2e-10)
    el = dict(prn=prn, sqrt_a=sqrt_a, e=e, i0=i0, omega_dot=omega_dot,
              m0=rng.uniform(-np.pi, np.pi), omega=rng.uniform(-np.pi, np.pi),
              omega0=rng.uniform(-np.pi, np.pi), delta_n=4.5e-9 + rng.normal(0, 3e-10),
              idot=rng.normal(0, 1e-10), cuc=rng.normal(0, 5e-6), cus=rng.normal(0, 5e-6),
              crc=rng.normal(200, 50), crs=rng.normal(0, 50), cic=rng.normal(0, 1e-7),
              cis=rng.normal(0, 1e-7), af0=rng.uniform(-5e-4, 5e-4), af1=rng.normal(0, 5e-12),
              af2=0.0, tgd=rng.normal(0, 5e-9))
    return {k: (v if k == "prn" else _rounded(v)) for k, v in el.items()}


def _nav_record(sys_c, el, toe_gps):
    """Eight lines of one GPS / BDS record: times in the system's own scale
    (BDT = GPST − 14 s, BDT week = GPS week − 1356)."""
    from .gnss.rinex import BDS_TIME_OFFSET, BDS_WEEK_OFFSET
    shift = BDS_TIME_OFFSET if sys_c == "C" else 0.0
    y, mo, d, hh, mi, ss = _gps_civil(toe_gps - shift)
    week = int((toe_gps - shift - 315964800.0) // 604800.0)
    sow = toe_gps - shift - 315964800.0 - week * 604800.0
    week -= BDS_WEEK_OFFSET if sys_c == "C" else 0
    rows = [[0.0, el["crs"], el["delta_n"], el["m0"]],
            [el["cuc"], el["e"], el["cus"], el["sqrt_a"]],
            [sow, el["cic"], el["omega0"], el["cis"]],
            [el["i0"], el["crc"], el["omega"], el["omega_dot"]],
            [el["idot"], 1.0, week, 0.0],
            [2.0, 0.0, el["tgd"], 0.0],
            [sow, 4.0, 0.0, 0.0]]
    head = (f"{sys_c}{el['prn']:02d} {y:4d} {mo:02d} {d:02d} {hh:02d} {mi:02d} {int(ss):02d}"
            + "".join(_d19(el[k]) for k in ("af0", "af1", "af2")))
    return [head] + ["    " + "".join(_d19(v) for v in r) for r in rows]


def _azel_all(sat_pos, rcv):
    """az, el (E, S) of satellites (E, S, 3) from receivers (E, 3)."""
    from .utils import coords as C
    R = C.ecef2enu_rotmat_np(C.ecef2llh_np(rcv))                    # (E, 3, 3)
    enu = np.einsum("eij,esj->esi", R, sat_pos - rcv[:, None, :])
    return (np.arctan2(enu[..., 0], enu[..., 1]),
            np.arctan2(enu[..., 2], np.linalg.norm(enu[..., :2], axis=-1)))


def _states(ephs, t_rx, psr):
    """tx_state_batch of the records (N,) whose ephemerides are ``ephs``."""
    from .gnss.ephemeris import stack_ephs, tx_state_batch
    return tx_state_batch(stack_ephs(ephs), t_rx, psr)


def write_synthetic_rinex(obs_path, nav_path, t_gps, rover_ecef, *, seed, systems="GC",
                          n_gps=8, n_bds=6, psr_noise=0.5, min_el_deg=20.0):
    """Write a RINEX 3 nav file and obs file of a receiver at ``rover_ecef``
    (E, 3) at the epochs ``t_gps`` (E,) (GPS seconds on the unix epoch).

    The nav file holds one record per satellite, toe at the whole hour
    nearest the middle epoch: ``n_gps`` GPS satellites (√A ≈ 5153.7) and
    ``n_bds`` BDS ones, the first a GEO (C01, √A ≈ 6493.4, the −5° frame)
    and the rest MEO (C11 on, √A ≈ 5282.6), each drawn from ``default_rng(seed)``
    until it stays above ``min_el_deg`` along the whole drive. No ionosphere
    coefficients: the converter's Klobuchar runs on its defaults, and so
    does the model here.

    The obs file has one C/L/D/S observable per system (C1C/L1C/D1C/S1C for
    GPS, C2I/L2I/D2I/S2I for BDS) and an APPROX POSITION of the first epoch.
    Pseudorange = range + Sagnac + c·(receiver clock − satellite clock) +
    c·TGD + Klobuchar + Saastamoinen (at the rover's own position) + noise of
    ``psr_noise`` m, the satellite at the transmission time the converter
    computes from that pseudorange; Doppler the range rate plus the receiver
    clock drift minus the satellite's, + 0.05 m/s of noise; carrier the
    phase range with an integer ambiguity; C/N0 from the elevation.
    Returns a dict of the satellites written ("sats") and the receiver
    clock (m) per epoch ("rcv_clock").
    """
    from .gnss import atmosphere
    from .gnss.converter import FREQ_B1, FREQ_L1
    from .gnss.ephemeris import CLIGHT
    from .gnss.rinex import parse_nav
    from .utils import coords as C
    rng = np.random.default_rng(seed)
    t_gps = np.asarray(t_gps, float)
    rover = np.asarray(rover_ecef, float)
    E = t_gps.shape[0]
    t_mid = t_gps[E // 2]
    toe = 315964800.0 + np.round((t_mid - 315964800.0) / 3600.0) * 3600.0
    sample = np.unique(np.linspace(0, E - 1, 12).astype(int))
    min_el = np.deg2rad(min_el_deg)

    header = [f"{'3.04':>9s}{'':11s}{'N: GNSS NAV DATA':<20s}{'M: MIXED':<20s}"
              "RINEX VERSION / TYPE",
              f"{'glio_tpu_torch':<20s}{'testing':<20s}{'':20s}PGM / RUN BY / DATE",
              f"{'':60s}END OF HEADER"]

    def write_nav(records):
        with open(nav_path, "w") as fh:
            fh.write("\n".join(header + [ln for s, el in records
                                          for ln in _nav_record(s, el, toe)]) + "\n")
        return parse_nav(nav_path)

    def visible(sys_c, el):
        eph = write_nav([(sys_c, el)])[f"{sys_c}{el['prn']:02d}"][0]
        pos, *_ = _states([eph] * len(sample), t_gps[sample], np.full(len(sample), 2.2e7))
        _, elev = _azel_all(pos[:, None, :], rover[sample])
        return elev.min() > min_el

    chosen = []       # (sys_c, elements)
    wanted = [("G", n_gps if "G" in systems else 0), ("C", n_bds if "C" in systems else 0)]
    for sys_c, n in wanted:
        prns = iter([1] + list(range(11, 60)) if sys_c == "C" else range(1, 33))
        prn = next(prns)
        while sum(c[0] == sys_c for c in chosen) < n:
            el = _candidate(rng, sys_c, prn, geo=sys_c == "C" and prn <= 5)
            if visible(sys_c, el):
                chosen.append((sys_c, el))
                prn = next(prns)
    # Every (epoch, satellite) record at once, from the elements as the
    # file holds them.
    nav = write_nav(chosen)
    names = [f"{s}{el['prn']:02d}" for s, el in chosen]
    S = len(names)
    ephs = [nav[n][0] for n in names] * E
    t_rx = np.repeat(t_gps, S)
    rcv = np.repeat(rover, S, axis=0)
    dt_r = 2e-4 + 1e-8 * (t_rx - t_gps[0])               # receiver clock (s)
    ddt_r = 1e-8                                          # its drift (s/s)
    v_rcv = np.repeat(np.gradient(rover, t_gps, axis=0), S, axis=0)
    is_bds = np.array([n[0] == "C" for n in names] * E)
    lam = np.where(is_bds, CLIGHT / FREQ_B1, CLIGHT / FREQ_L1)
    f_scale = np.where(is_bds, (FREQ_L1 / FREQ_B1) ** 2, 1.0)
    llh = C.ecef2llh_np(rcv)
    _, tow = C.unix2gpst(t_rx)
    noise = psr_noise * rng.normal(size=E * S)
    tgd = np.array([e.tgd for e in ephs]) * CLIGHT
    psr = np.full(E * S, 2.2e7)
    for _ in range(3):
        pos, vel, clk, ddt = _states(ephs, t_rx, psr)
        az, elev = _azel_all(pos.reshape(E, S, 3), rover)
        az, elev = az.reshape(-1), elev.reshape(-1)
        iono = atmosphere.klobuchar(tow, llh[:, 0], llh[:, 1], az, elev) * f_scale
        tropo = np.concatenate([atmosphere.saastamoinen(llh[e * S, 0], llh[e * S, 2],
                                                        elev[e * S:(e + 1) * S])
                                for e in range(E)])
        rho = np.linalg.norm(pos - rcv, axis=-1)
        sagnac = C.OMGE / CLIGHT * (pos[:, 0] * rcv[:, 1] - pos[:, 1] * rcv[:, 0])
        geom = rho + sagnac + CLIGHT * dt_r - CLIGHT * clk
        psr = geom + tgd + iono + tropo + noise
    los = (pos - rcv) / rho[:, None]
    rate = np.sum((vel - v_rcv) * los, -1) + C.OMGE / CLIGHT * (
        vel[:, 0] * rcv[:, 1] + pos[:, 0] * v_rcv[:, 1]
        - vel[:, 1] * rcv[:, 0] - pos[:, 1] * v_rcv[:, 0])
    dopp_hz = -(rate + CLIGHT * ddt_r - ddt * CLIGHT + 0.05 * rng.normal(size=E * S)) / lam
    amb = np.tile(rng.integers(-200000, 200000, size=S), E)
    carrier = (geom + tropo - iono + 0.003 * rng.normal(size=E * S)) / lam + amb
    snr = np.clip(28.0 + 22.0 * np.sin(elev) + rng.normal(size=E * S), 20.0, 55.0)
    keep = elev > np.deg2rad(10.0)

    obs_types = {"G": ("C1C", "L1C", "D1C", "S1C"), "C": ("C2I", "L2I", "D2I", "S2I")}
    ax = rover[0]
    out = [f"{'3.04':>9s}{'':11s}{'OBSERVATION DATA':<20s}{'M: MIXED':<20s}"
           "RINEX VERSION / TYPE",
           f"{'glio_tpu_torch':<20s}{'testing':<20s}{'':20s}PGM / RUN BY / DATE",
           f"{ax[0]:14.4f}{ax[1]:14.4f}{ax[2]:14.4f}{'':18s}APPROX POSITION XYZ"]
    for sys_c in "GC":
        if sys_c in systems:
            out.append(f"{sys_c}{4:5d} {' '.join(obs_types[sys_c])}".ljust(60)
                       + "SYS / # / OBS TYPES")
    out.append(f"{'':60s}END OF HEADER")
    for e in range(E):
        y, mo, d, hh, mi, ss = _gps_civil(t_gps[e])
        rows = [r for r in range(e * S, (e + 1) * S) if keep[r]]
        out.append(f"> {y:4d} {mo:02d} {d:02d} {hh:02d} {mi:02d}{ss:11.7f}  0{len(rows):3d}")
        for r in rows:
            out.append(names[r % S] + "".join(
                f"{v:14.3f}  " for v in (psr[r], carrier[r], dopp_hz[r], snr[r])).rstrip())
    with open(obs_path, "w") as fh:
        fh.write("\n".join(out) + "\n")
    return {"sats": names, "rcv_clock": CLIGHT * dt_r[::S]}


def files_digest(*paths) -> str:
    """sha256 of the files' bytes, in order."""
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def gnss_drive(sc):
    """The drive of the GNSS phase: ``drifted_trajectory(n_keyframes)`` (the
    batch phase's 3 Hz drive) on the clock of ``GNSS_T0``, with an epoch
    ``epoch_offset`` s after every ``epoch_stride``-th keyframe. Returns
    (kf_time (GPS seconds on the unix epoch), p_true, q_true, p_odo, t_gps,
    rover_ecef (E, 3) at the configured anchor)."""
    from .config import GlioConfig
    from .data.simulator import drifted_trajectory
    from .utils import coords as C
    kf_rel, p_true, q_true, p_odo = drifted_trajectory(sc["n_keyframes"], sc["max_drift"])
    t0 = gps_unix(*GNSS_T0)
    idx = np.arange(0, sc["n_keyframes"], sc["epoch_stride"])
    t_gps = t0 + kf_rel[idx] + sc["epoch_offset"]
    rover = C.enu2ecef_np(p_true[idx], np.asarray(GlioConfig().initialization.anc_ecef))
    return t0 + kf_rel, p_true, q_true, p_odo, t_gps, rover


# --- the GNSS phase's scenarios (``chip_smoke.py`` phase 15) --------------------------

GNSS_BATCH = dict(thresholds=(1e9, 10.0, 8.0, 6.0), lm_iters=10, dd_huber=1.0,
                  epoch_gate=2.0, rel_huber=5.0)
# ``scripts/long_run.py:26-36`` on ``simulate_episode(seed=3)`` with GNSS at
# every keyframe, cut from 600 keyframes to 30.
LONG_RUN = dict(n_keyframes=30, scan_points=1024, seed=3, psr_noise=0.5, epoch_stride=1,
                every=10)
# Phase 7's episode with GNSS and Doppler rows in the window and the batch.
DOPPLER_WINDOW = dict(n_keyframes=15, scan_points=1024, seed=0, gnss_seed=0, epoch_stride=1)


def gnss_batch_config(config_module, solver="direct"):
    """The default configuration with Doppler rows in the batch."""
    base = config_module.GlioConfig()
    return base.replace(estimator=dataclasses.replace(base.estimator, doppler_in_batch=True,
                                                      batch_solver=solver))


def long_run_config(config_module):
    """``scripts/long_run.py:26-36``: 1024-point scans, a 16,384-point map,
    window map width 20, 15 LM iterations, DD rows in the window (no
    Doppler), the ``chol_pcg`` batch solver."""
    c = config_module
    return c.GlioConfig().replace(
        shapes=c.ShapeConfig(max_imu_per_interval=40, scan_points=1024, map_points=16384),
        estimator=c.EstimatorConfig(local_map_width=20, sw_max_iter=15,
                                    gnss_in_sliding_window=True, doppler_in_window=False,
                                    batch_solver="chol_pcg"))


def doppler_window_config(config_module):
    """The bench shapes (``bench.py``: 1024-point scans, a 16,384-point map,
    window map width 50, 15 LM iterations) with DD and Doppler rows in the
    window and Doppler rows in the batch."""
    c = config_module
    return c.GlioConfig().replace(
        shapes=c.ShapeConfig(max_imu_per_interval=40, scan_points=1024, map_points=16384),
        estimator=c.EstimatorConfig(local_map_width=50, sw_max_iter=15,
                                    gnss_in_sliding_window=True, doppler_in_window=True,
                                    doppler_in_batch=True))


def gnss_episode(sc, simulate_episode, simulate_gnss_epochs, anchor, station):
    """``simulate_episode`` of ``sc`` with ``simulate_gnss_epochs`` on its
    truth (the caller's simulator: the JAX package's or the port's)."""
    ep = simulate_episode(n_keyframes=sc["n_keyframes"], scan_points=sc["scan_points"],
                          seed=sc["seed"])
    ep.gnss = simulate_gnss_epochs(ep.gt_p, ep.kf_time, anchor, station,
                                   psr_noise=sc.get("psr_noise", 0.5),
                                   epoch_stride=sc["epoch_stride"],
                                   seed=sc.get("gnss_seed", sc["seed"]))
    ep.anchor_ecef = np.asarray(anchor)
    return ep


def gnss_fields_digest(g) -> dict:
    """Per field of a ``GnssEpochs``: the sha256 of the bytes of its integer
    and boolean arrays, [sum, sum of squares] of its float arrays."""
    out = {}
    for f in dataclasses.fields(g):
        a = getattr(g, f.name)
        if a is None:
            continue
        a = np.asarray(a)
        if a.dtype.kind in "biu":
            out[f.name] = f"{a.dtype.str}:{hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()}"
        else:
            out[f.name] = [float(a.sum()), float((a * a).sum())]
    return out


# --- the multi-device batch solve: ranks of ``parallel.launch.run_ranks`` ---------------

ANCHOR_ECEF = np.array([-2419233.42, 5385473.13, 2405341.30])
STATION_ECEF = np.array([-2414266.92, 5386768.987, 2407460.031])
# tests/test_parallel.py::test_optimize_batch_sharded_matches_single_device's drive
SHARDED_DRIVE = dict(n_keyframes=96, seed=5, psr_noise=0.5, epoch_stride=2, odo_noise=0.4,
                     thresholds=(1e9, 8.0), lm_iters=4, dd_huber=1.0, epoch_gate=2.0,
                     rel_huber=5.0)


def sharded_drive(sc, simulate_gnss_epochs):
    """(kf_time, p_true, q_true, gnss, p_odo) of ``SHARDED_DRIVE``: a 20 m/s
    S-curve at 3 Hz, GNSS every ``epoch_stride`` keyframes and white
    odometry noise, from the caller's simulator (the JAX package's or the
    port's)."""
    T = sc["n_keyframes"]
    kf_time = np.arange(T) / 3.0
    t = np.linspace(0, 2, T)
    p_true = np.stack([20 * t, 5 * np.sin(t), np.zeros_like(t)], -1)
    q_true = np.tile([1.0, 0, 0, 0], (T, 1))
    gnss = simulate_gnss_epochs(p_true, kf_time, ANCHOR_ECEF, STATION_ECEF,
                                psr_noise=sc["psr_noise"], epoch_stride=sc["epoch_stride"],
                                seed=sc["seed"])
    p_odo = p_true + sc["odo_noise"] * np.random.default_rng(sc["seed"]).normal(size=p_true.shape)
    return kf_time, p_true, q_true, gnss, p_odo


def robust_opts(batch_mod, sc):
    return batch_mod.RobustOpts(dd_huber=sc["dd_huber"], epoch_gate=sc["epoch_gate"],
                                rel_huber=sc["rel_huber"])


def damped_band(batch_mod, prob, p, q, threshold, hw, robust, lam=1e-4):
    """The band and gradient of an LM iteration of the level-0 batch at (p,
    q), damped by ``lam`` as ``solve_batch_once`` damps them."""
    band, grad, *_ = batch_mod._assemble_core_impl(p, q, prob, threshold, hw, robust=robust)
    batch_mod._damp(band, lam, hw)
    return band, grad


def pad_time(band, b, sp):
    """(NB, T, ...) band and rhs padded along T to a multiple of ``sp`` with
    identity diagonal blocks and zero rhs rows, as ``make_sharded_pcg`` asks."""
    pad = -band.shape[1] % sp
    if not pad:
        return band, b
    D, hw = band.shape[-1], (band.shape[2] - 1) // 2
    tail = torch.zeros(band.shape[:1] + (pad,) + band.shape[2:], dtype=band.dtype,
                       device=band.device)
    tail[:, :, hw] = torch.eye(D, dtype=band.dtype, device=band.device)
    zero = torch.zeros(b.shape[:1] + (pad, D), dtype=b.dtype, device=b.device)
    return torch.cat([band, tail], 1), torch.cat([b, zero], 1)


def parallel_cases(rank, world_size, device, cases):
    """Every CPU parity case of ``tests/test_torch_parallel.py`` in one set of
    ranks: the sharded CR solve on each (band, b, hw) of ``cases["cr"]``, the
    halo matvec on each of ``cases["halo"]`` over all ranks, the sharded PCG at
    dp = 2, sp = 2 (``"pcg"``) and at sp = 1 (``"pcg_sp1"``), the uneven-shard
    error (``"uneven"``) and ``optimize_batch_sharded`` on ``sharded_drive``;
    and the JAX modules the rank has imported (``"jax_modules"``: none)."""
    from .config import GlioConfig
    from .data.simulator import simulate_gnss_epochs
    from .models import batch as batch_mod
    from .parallel import Comm, banded_pcg, spike_cr

    def t(a):
        return torch.as_tensor(a, device=device)

    out = {"cr": [spike_cr.make_sharded_cr_solve(None, hw)(t(band), t(b))
                  for band, b, hw in cases["cr"]]}
    comm = Comm()
    out["halo"] = []
    for band, x, hw in cases["halo"]:
        cols = slice(rank * (x.shape[1] // world_size), (rank + 1) * (x.shape[1] // world_size))
        y = banded_pcg._halo_matvec(t(band[:, cols]), t(x[:, cols]), hw, comm)
        out["halo"].append(torch.cat(comm.all_gather(y), dim=1))
    for key, dp in (("pcg", 2), ("pcg_sp1", world_size)):
        band, b, hw, iters = cases[key]
        out[key] = banded_pcg.make_sharded_pcg(None, hw, iters, dp=dp)(t(band), t(b))
    band, b, hw, iters = cases["uneven"]
    try:
        banded_pcg.make_sharded_pcg(None, hw, iters, dp=2)(t(band), t(b))
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)
    sc = cases["batch"]
    kf_time, _, q_true, gnss, p_odo = sharded_drive(sc, simulate_gnss_epochs)
    cfg = GlioConfig()
    prob = batch_mod.build_problem(cfg, p_odo, q_true, kf_time, gnss, ANCHOR_ECEF, 0.0,
                                   STATION_ECEF, device=device)
    out["batch"] = batch_mod.optimize_batch_sharded(
        cfg, prob, None, thresholds=sc["thresholds"], lm_iters=sc["lm_iters"],
        robust=robust_opts(batch_mod, sc))
    import sys
    out["jax_modules"] = sorted(m for m in sys.modules
                                if m == "jax" or m.startswith(("jax.", "glio_tpu.")))
    return out


def failing_rank(rank, world_size, device, bad_rank):
    """Rank ``bad_rank`` raises before the first collective; the others wait in it."""
    from .parallel import Comm
    if rank == bad_rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    return Comm().all_gather(torch.ones(1, device=device))


def batch_drive_problem(sc, cfg, device):
    """The batch fixture's problem (``tests/data/batch_T3493_seed4.npz``'s
    scenario ``sc``) built by the port on ``device``: (problem, p_true,
    p_odo, host seconds to simulate, seconds to build, closed by a sync)."""
    import time
    from .data.simulator import drifted_trajectory, simulate_gnss_epochs
    from .models import batch as batch_mod
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    t0 = time.perf_counter()
    kf_time, p_true, q_true, p_odo = drifted_trajectory(sc["n_keyframes"], sc["max_drift"])
    gnss = simulate_gnss_epochs(p_true, kf_time, anchor, station, psr_noise=sc["psr_noise"],
                                epoch_stride=sc["epoch_stride"], seed=sc["seed"])
    t1 = time.perf_counter()
    prob = batch_mod.build_problem(cfg, p_odo, q_true, kf_time, gnss, anchor, 0.0, station,
                                   device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return prob, p_true, p_odo, t1 - t0, time.perf_counter() - t1


def sharded_batch_bands(batch_mod, cfg, prob, sc, at_solution, at_jax, lam=1e-4):
    """The bands of the multi-device phase, each damped by ``lam`` as an LM
    iteration damps it: (band, rhs) at ``at_solution`` (p, q) with the last
    threshold, for the sharded direct solve; and the two bands of the sharded
    PCG (at the odometry with the first threshold, at ``at_jax`` with the
    last) stacked and padded to an even T."""
    hw = cfg.estimator.search_range + 1
    robust = robust_opts(batch_mod, sc)
    th = sc["thresholds"]
    band, grad = damped_band(batch_mod, prob, *at_solution, th[-1], hw, robust, lam)
    pair = [damped_band(batch_mod, prob, prob.p_odo, prob.q_odo, th[0], hw, robust, lam),
            damped_band(batch_mod, prob, *at_jax, th[-1], hw, robust, lam)]
    band2, b2 = pad_time(torch.stack([b for b, _ in pair]), -torch.stack([g for _, g in pair]), 2)
    return (band, -grad), (band2, b2)


def sharded_batch_rank(rank, world_size, device, spec):
    """One rank of ``chip_smoke.py``'s multi-device phase: the batch drive's
    problem built on the host; the sharded direct solve of its band at the
    single-device solution and the sharded PCG (dp = 2, sp = 2) of the two
    bands of ``sharded_batch_bands``, those bands made from the whole problem
    copied to ``device``; the first assembly of ``optimize_batch_sharded``
    (at the odometry, the first threshold), this rank's rows of it
    (``parallel.assembly.RankShare``) against the whole band's, each timed
    over ``spec["assembly_reps"]`` calls with its peak device memory; then,
    with nothing of the whole problem left on the device,
    ``optimize_batch_sharded`` itself. Each solve is timed (host clock,
    closed by a synchronize) with its collectives' count, bytes and
    seconds."""
    import time
    t_ready = time.time()
    import torch.distributed as dist
    from .config import GlioConfig
    from .models import batch as batch_mod
    from .parallel import Comm, assembly, banded_pcg, spike_cr
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sc = spec["scenario"]
    cfg = GlioConfig()
    hw = cfg.estimator.search_range + 1
    robust = robust_opts(batch_mod, sc)
    t0 = time.perf_counter()
    host = batch_drive_problem(sc, cfg, "cpu")[0]
    prob = batch_mod.BatchProblem(*(x.to(device) for x in host))

    def t(a):
        return torch.as_tensor(a, device=device)

    (band, rhs), (band2, b2) = sharded_batch_bands(
        batch_mod, cfg, prob, sc, (t(spec["p_solution"]), t(spec["q_solution"])),
        (t(spec["p_jax"]), t(spec["q_jax"])))
    sync()
    out = {"t_ready": t_ready, "setup_s": time.perf_counter() - t0, "rank": rank}

    def timed(name, fn, comm):
        fn()                                        # warm-up
        calls, nbytes, secs = comm.calls, comm.bytes, comm.seconds
        sync()
        t1 = time.perf_counter()
        res = fn()
        sync()
        out[f"{name}_s"] = time.perf_counter() - t1
        out[f"{name}_comm"] = (comm.calls - calls, comm.bytes - nbytes, comm.seconds - secs)
        return res

    cr = spike_cr.make_sharded_cr_solve(None, hw)
    out["x_cr"] = timed("cr", lambda: cr(band, rhs), cr.comm)
    pcg = banded_pcg.make_sharded_pcg(None, hw, spec["pcg_iters"], dp=2, sp=2)
    out["x_pcg"], out["res_pcg"] = timed("pcg", lambda: pcg(band2, b2), pcg.comm)
    out["pcg_sp_comm"] = (pcg.sp_comm.calls, pcg.sp_comm.bytes, pcg.sp_comm.seconds)
    del band, rhs, band2, b2

    def memory():                               # None: no device memory to read
        return torch.cuda.memory_allocated(device) if cuda else None

    def peak():
        return torch.cuda.max_memory_allocated(device) if cuda else None

    def assembly_ms(name, fn):
        """ms a call over the ranks' concurrent calls, and the peak bytes."""
        fn()
        dist.barrier()
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        out[f"{name}_resident"] = memory()
        t1 = time.perf_counter()
        for _ in range(spec["assembly_reps"]):
            res = fn()
        sync()
        out[f"{name}_ms"] = 1e3 * (time.perf_counter() - t1) / spec["assembly_reps"]
        out[f"{name}_peak"] = peak()
        return res

    th0 = sc["thresholds"][0]
    plan = batch_mod.assembly_plan(prob, hw)
    assembly_ms("whole", lambda: batch_mod._assemble_core_impl(
        prob.p_odo, prob.q_odo, prob, th0, hw, robust=robust, plan=plan))
    p0, q0 = prob.p_odo, prob.q_odo
    del prob, plan
    share = assembly.RankShare(host, hw, rank, world_size, cfg.estimator.doppler_in_batch,
                               device)
    out["rows"] = assembly_ms("local", lambda: share.assemble(p0, q0, th0, robust))[:3]
    out["part"] = tuple(share.part)
    out["held"] = (share.prob.p_odo.shape[0], len(share.epochs)) if share.prob else (0, 0)
    out["whole"] = (host.p_odo.shape[0], host.ep_left.shape[0])
    del share, p0, q0
    comm = Comm()
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    out["batch_resident"] = memory()
    t1 = time.perf_counter()
    p, q, costs = batch_mod.optimize_batch_sharded(
        cfg, host, comm, thresholds=sc["thresholds"], lm_iters=sc["lm_iters"], robust=robust,
        device=device)
    sync()
    out["batch_s"] = time.perf_counter() - t1
    out["batch_peak"] = peak()
    out["batch_comm"] = (comm.calls, comm.bytes, comm.seconds)
    out.update(p=p, q=q, costs=costs)
    if rank:       # every rank returns the same vectors; rank 0's are kept
        del out["x_cr"], out["x_pcg"]
    return out


def item9_cases(device):
    """The small public functions off the pipeline's paths (``factors.lidar``'s
    four rows, ``whitened_residual``, ``gn_solve`` / ``dogleg_solve``, the prior
    helpers, SO(3), ``from_rotmat`` / ``g2q``, ``gpst2unix`` / ``sat_azel``, the
    npz checkpoint and the profiler's sync) on ``device``, on inputs made from
    a numpy seed: {name: (result tensors on the CPU, seconds)}."""
    import os
    import tempfile
    import time
    from .factors import imu, lidar
    from .solver import dense, marginalization
    from .utils import checkpoint, coords, profiling, quat, so3
    rng = np.random.default_rng(19)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    def unit(n, d=4):
        x = rng.normal(size=(n, d))
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    N = 4096
    pts, nrm = rng.normal(size=(N, 3)) * 20, unit(N, 3)
    q1, q2 = unit(1)[0], unit(1)[0]
    mask = torch.as_tensor(rng.random(N) > 0.2, device=device)
    th = unit(256, 3) * rng.uniform(0.0, 3.1, size=(256, 1))
    th[0] = 0.0
    th[1] = unit(1, 3)[0] * (np.pi - 1e-7)
    R = so3.exp(t(th))
    qa, qb = unit(N), unit(N)
    pre = imu.preintegrate(t(rng.normal(size=(40, 3)) + [0, 0, 9.8]),
                           t(rng.normal(size=(40, 3)) * 0.1), t(np.full(40, 0.005)),
                           torch.ones(40, dtype=torch.bool, device=device), t(np.zeros(3)),
                           t(np.zeros(3)), t([0, 0, 9.8]), t(np.zeros(3)),
                           imu.ImuParams().noise_cov().to(device))
    state = [t(rng.normal(size=3)), t(unit(1)[0]), t(rng.normal(size=3)), t(np.zeros(3)),
             t(np.zeros(3)), t(rng.normal(size=3)), t(unit(1)[0]), t(rng.normal(size=3)),
             t(np.zeros(3)), t(np.zeros(3))]
    J = rng.normal(size=(30, 12))
    prior = marginalization.marginalize(t(J.T @ J), t(J.T @ rng.normal(size=30)), 6)
    rcv = t([-2414266.92, 5386768.987, 2407460.031])
    sats = t(rng.normal(size=(64, 3)) * 1.5e7) + 4.0 * rcv

    def rosen(x):
        return torch.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])

    def ckpt():
        with tempfile.TemporaryDirectory() as d:
            tree = {"R": R, "pre": pre}
            checkpoint.save_pytree(os.path.join(d, "c.npz"), tree)
            return checkpoint._leaves(checkpoint.load_pytree(os.path.join(d, "c.npz"), tree))

    def profiled():
        prof = profiling.Profiler()
        return prof.time_fn("so3_log", so3.log, R)

    x0 = t([-1.2, 1.0])
    cases = {
        "plane_incre_residual": lambda: lidar.plane_incre_residual(
            t(pts), t(nrm), t(rng.normal(size=N)), t([1.0, 2.0, 3.0]), t(q1), mask),
        "edge_residual": lambda: lidar.edge_residual(
            t(pts), t(pts + 1.0), t(pts - [2.0, 0, 1.0]), t(np.ones(N)), t([1.0, 2.0, 3.0]),
            t(q1), t(q2), t([0.1, 0.0, 0.2]), mask),
        "relative_attitude_residual": lambda: lidar.relative_attitude_residual(
            t(qa), t(qb), t(unit(N)), t(np.full(N, 1e4)), mask),
        "roll_pitch_residual": lambda: lidar.roll_pitch_residual(t(qa), t(unit(N, 3))),
        "whitened_residual": lambda: imu.whitened_residual(pre, *state,
                                                           gravity=t([0, 0, 9.8])),
        "gn_solve": lambda: dense.gn_solve(rosen, lambda x, d: x + d, x0, 2, max_iters=20).x,
        "dogleg_solve": lambda: dense.dogleg_solve(rosen, lambda x, d: x + d, x0, 2,
                                                   max_iters=60).x,
        "prior_residual": lambda: torch.cat([
            marginalization.prior_residual(prior, t(np.ones(6))),
            marginalization.prior_residual(marginalization.identity_prior(6, device=device),
                                           t(np.ones(6)))]),
        "so3_vee_exp": lambda: torch.cat([so3.vee(R).reshape(-1), R.reshape(-1)]),
        "so3_log": lambda: so3.log(R),
        "so3_jacobians": lambda: torch.stack([so3.left_jacobian(t(th)),
                                              so3.right_jacobian(t(th)),
                                              so3.inv_right_jacobian(t(th * 0.5))]),
        "from_rotmat": lambda: quat.from_rotmat(R),
        "g2q": lambda: quat.g2q(t(rng.normal(size=(64, 3)) * 0.5 + [0, 0, 9.7])),
        "gpst2unix": lambda: coords.gpst2unix(t([2158.0, 2200.0]), t([455342.266, 1.5])),
        "sat_azel": lambda: torch.stack(coords.sat_azel(rcv, sats)),
        "checkpoint": lambda: torch.cat([x.reshape(-1).to(torch.float64) for x in ckpt()]),
        "profiler": profiled,
    }
    out = {}
    for name, fn in cases.items():
        t0 = time.perf_counter()
        res = fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        out[name] = (res.detach().cpu(), time.perf_counter() - t0, res.device.type)
    return out
