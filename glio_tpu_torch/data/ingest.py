"""Raw-sensor ingest: rosbag1 / PCD sequence / arrays → Episode (port of
``glio_tpu/data/ingest.py``).

The reference reads ``/velodyne_points`` (sensor_msgs/PointCloud2) and
``/imu/data`` (sensor_msgs/Imu) from a ROS1 bag
(``GLIO/src/Preprocessing.cpp:133-138``). This module is the port's way in
for such a log:

* the pure-python rosbag v2.0 reader (uncompressed and bz2 chunks) and the
  ROS1 message decoders, copied from the JAX package (host numpy);
* ``episode_from_streams``: raw scans + IMU → ring organisation on the host
  (``organize_scan``, rings by ``lidar.features.ring_from_elevation`` for
  unorganised clouds), LOAM features and the 0.4 m surf cloud
  (``models.preprocessing``) and scan-to-map odometry with keyframe
  selection (``models.lidar_odometry``, the 5-NN kernel on the card) on
  ``device``, then IMU interval binning, gravity alignment of the initial
  attitude (``Utility::g2R``, common.h:134-276) and the dense channel on the
  host: the same ``Episode`` the simulator makes, so ``run_pipeline`` runs
  real data unchanged.

The features and the odometry run on the device they are given and never
move to another.
"""

import bz2
import glob as glob_mod
import os
import struct
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config import GlioConfig
from ..eval.pointcloud import read_pcd
from ..lidar import features
from ..models.lidar_odometry import make_odometry
from ..models.preprocessing import make_preprocessor
from ..utils import quat
from .episode import Episode

# --- rosbag v2.0 container ----------------------------------------------------

_MAGIC = b"#ROSBAG V2.0\n"


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    fields = {}
    o = 0
    while o < len(buf):
        (n,) = struct.unpack_from("<I", buf, o)
        o += 4
        kv = buf[o:o + n]
        o += n
        k, _, v = kv.partition(b"=")
        fields[k] = v
    return fields


def _iter_records(buf: bytes, offset: int = 0) -> Iterator[Tuple[Dict, bytes]]:
    o = offset
    n_total = len(buf)
    while o + 8 <= n_total:
        (hlen,) = struct.unpack_from("<I", buf, o)
        o += 4
        hdr = _parse_header(buf[o:o + hlen])
        o += hlen
        (dlen,) = struct.unpack_from("<I", buf, o)
        o += 4
        data = buf[o:o + dlen]
        o += dlen
        yield hdr, data


def read_bag(path: str, topics: Optional[List[str]] = None):
    """Read a ROS1 v2.0 bag: returns (connections, messages).

    connections: {conn_id: {"topic", "type", "md5sum"}}
    messages: list of (topic, type, t_seconds, raw_bytes) sorted by time.
    Chunk compressions 'none' and 'bz2' are supported ('lz4' would need
    the lz4 package — not baked in; raise clearly).
    """
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(_MAGIC):
        raise ValueError(f"{path}: not a ROS bag v2.0 file")
    conns: Dict[int, Dict[str, str]] = {}
    msgs = []

    def handle(hdr, data):
        op = hdr.get(b"op", b"\x00")[0]
        if op == 0x07:                       # connection
            cid = struct.unpack("<I", hdr[b"conn"])[0]
            ch = _parse_header(data)
            conns[cid] = {
                "topic": ch.get(b"topic", hdr.get(b"topic", b"")).decode(),
                "type": ch.get(b"type", b"").decode(),
                "md5sum": ch.get(b"md5sum", b"").decode(),
            }
        elif op == 0x02:                     # message data
            cid = struct.unpack("<I", hdr[b"conn"])[0]
            secs, nsecs = struct.unpack("<II", hdr[b"time"])
            c = conns.get(cid)
            if c is None:
                return
            if topics is None or c["topic"] in topics:
                msgs.append((c["topic"], c["type"],
                             secs + 1e-9 * nsecs, data))
        elif op == 0x05:                     # chunk
            comp = hdr.get(b"compression", b"none").decode()
            if comp == "none":
                sub = data
            elif comp == "bz2":
                sub = bz2.decompress(data)
            else:
                raise NotImplementedError(
                    f"bag chunk compression '{comp}' not supported "
                    "(none/bz2 are)")
            for h2, d2 in _iter_records(sub):
                handle(h2, d2)
        # op 0x03 (bag header), 0x04 (index), 0x06 (chunk info): skip.

    for hdr, data in _iter_records(blob, len(_MAGIC)):
        handle(hdr, data)
    msgs.sort(key=lambda m: m[2])
    return conns, msgs


# --- ROS1 message decoding ----------------------------------------------------

def _read_string(buf, o):
    (n,) = struct.unpack_from("<I", buf, o)
    return buf[o + 4:o + 4 + n].decode(errors="replace"), o + 4 + n


def parse_imu(raw: bytes):
    """sensor_msgs/Imu → (stamp, quat_wxyz(4,), gyr(3,), acc(3,))."""
    o = 4                                    # header.seq
    secs, nsecs = struct.unpack_from("<II", raw, o)
    o += 8
    _, o = _read_string(raw, o)              # frame_id
    x, y, z, w = struct.unpack_from("<4d", raw, o)
    o += 32 + 72                             # orientation + its covariance
    gx, gy, gz = struct.unpack_from("<3d", raw, o)
    o += 24 + 72
    ax, ay, az = struct.unpack_from("<3d", raw, o)
    return (secs + 1e-9 * nsecs, np.array([w, x, y, z]),
            np.array([gx, gy, gz]), np.array([ax, ay, az]))


_PF_DTYPE = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
             5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}


def parse_pointcloud2(raw: bytes):
    """sensor_msgs/PointCloud2 → (stamp, dict of field arrays).

    Always returns 'xyz' (N, 3) float32; also 'ring'/'time'/'t' when the
    cloud carries them (Velodyne/Ouster clouds do)."""
    o = 4
    secs, nsecs = struct.unpack_from("<II", raw, o)
    o += 8
    _, o = _read_string(raw, o)
    height, width = struct.unpack_from("<II", raw, o)
    o += 8
    (n_fields,) = struct.unpack_from("<I", raw, o)
    o += 4
    fields = []
    for _ in range(n_fields):
        name, o = _read_string(raw, o)
        off, dt, cnt = struct.unpack_from("<IBI", raw, o)
        o += 9
        fields.append((name, off, dt, cnt))
    is_bigendian = raw[o]
    o += 1
    point_step, row_step = struct.unpack_from("<II", raw, o)
    o += 8
    (dlen,) = struct.unpack_from("<I", raw, o)
    o += 4
    data = np.frombuffer(raw, np.uint8, count=dlen, offset=o)
    if is_bigendian:
        raise NotImplementedError("big-endian PointCloud2")
    n = (height * width) if point_step == 0 else dlen // point_step
    rec = data[: n * point_step].reshape(n, point_step)
    out = {}
    cols = {}
    for name, off, dt, cnt in fields:
        dtype = _PF_DTYPE.get(dt)
        if dtype is None or cnt != 1:
            continue
        w_ = np.dtype(dtype).itemsize
        cols[name] = rec[:, off:off + w_].copy().view(dtype)[:, 0]
    if all(k in cols for k in ("x", "y", "z")):
        out["xyz"] = np.stack([cols["x"], cols["y"], cols["z"]],
                              -1).astype(np.float32)
    for k in ("ring", "time", "t", "intensity"):
        if k in cols:
            out[k] = cols[k]
    return secs + 1e-9 * nsecs, out


# --- scan organization + front-end chain --------------------------------------

def organize_scan(xyz: np.ndarray, ring: Optional[np.ndarray],
                  n_rings: int, n_cols: int = 900,
                  min_range: float = 3.0):
    """Unordered cloud → (n_rings, n_cols, 3) ring-ordered range image.

    Ring IDs from the cloud's ring field when present; otherwise by elevation angle
    exactly as the reference computes them for HDL-32E/VLP-16/HDL-64
    (``Preprocessing.cpp:441-487`` — the features.ring_from_elevation
    rule, on the host). Azimuth indexes the column; nearest return wins a
    cell.
    """
    xyz = np.asarray(xyz, np.float32)
    finite = np.isfinite(xyz).all(-1)
    rng = np.linalg.norm(xyz, axis=-1)
    keep = finite & (rng > min_range)        # removeClosedPointCloud(3m)
    if ring is None:
        ring_t, ring_ok = features.ring_from_elevation(
            torch.from_numpy(np.where(keep[:, None], xyz, np.float32(1.0))), n_rings)
        ring = ring_t.numpy()
        keep = keep & ring_ok.numpy()
    ring = np.asarray(ring).astype(int)
    az = np.arctan2(xyz[:, 1], xyz[:, 0])
    col = np.clip(((az + np.pi) / (2 * np.pi) * (n_cols - 1)).round()
                  .astype(int), 0, n_cols - 1)
    ok = keep & (ring >= 0) & (ring < n_rings)
    img = np.zeros((n_rings, n_cols, 3), np.float32)
    best = np.full((n_rings, n_cols), np.inf, np.float32)
    idx = np.nonzero(ok)[0]
    # Nearest-return per cell, vectorized: sort by range descending so the
    # last write per cell is the closest point.
    order = idx[np.argsort(-rng[idx], kind="stable")]
    img[ring[order], col[order]] = xyz[order]
    best[ring[order], col[order]] = rng[order]
    valid = np.isfinite(best)
    return img, valid


def _clock(device, record):
    """Host seconds, after the device's queued work when ``record`` is kept."""
    if record is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def episode_from_streams(cfg: GlioConfig,
                         scan_time: np.ndarray,
                         scans: List[np.ndarray],
                         imu_time: np.ndarray,
                         imu_acc: np.ndarray,
                         imu_gyr: np.ndarray,
                         rings: Optional[List[np.ndarray]] = None,
                         n_cols: int = 900,
                         max_dense: int = 4,
                         verbose: bool = False,
                         device="cuda",
                         record: Optional[dict] = None) -> Episode:
    """Raw scans + IMU stream → tensorized Episode (see module doc).

    ``record``, when given, receives the host seconds of the organisation,
    the preprocessing and the odometry (``organize_s``, ``preprocess_s``,
    ``odometry_s``, each closed by a device sync) and the front end's
    outputs on ``device``: every frame's ``surf`` and ``surf_valid``, and
    ``odom`` (an OdomOutput).
    """
    device = torch.device(device)
    lo = cfg.lidar_odometry
    S = cfg.shapes.scan_points
    N = len(scans)
    NI = cfg.shapes.max_imu_per_interval
    scan_time = np.asarray(scan_time, float)
    imu_time = np.asarray(imu_time, float)
    imu_acc = np.asarray(imu_acc, float)
    imu_gyr = np.asarray(imu_gyr, float)

    # 1. Organise (host) + LOAM features per scan (device).
    t0 = _clock(device, record)
    imgs = [organize_scan(scans[i], rings[i] if rings is not None else None,
                          lo.line_num, n_cols) for i in range(N)]
    t1 = _clock(device, record)
    pre = make_preprocessor(cfg, device, surf_out=S)
    surf_t = torch.zeros((N, S, 3), dtype=torch.float32, device=device)
    surf_valid_t = torch.zeros((N, S), dtype=torch.bool, device=device)
    for i, (img, v) in enumerate(imgs):
        out = pre(torch.from_numpy(img), torch.from_numpy(v))
        surf_t[i], surf_valid_t[i] = out.surf, out.surf_valid
        if verbose and i % 50 == 0:
            print(f"  features {i}/{N}", flush=True)
    t2 = _clock(device, record)

    # 2. Scan-to-map odometry over all frames (keyframe selection).
    outs = make_odometry(cfg, device)(surf_t, surf_valid_t)
    t3 = _clock(device, record)
    if record is not None:
        record.update(organize_s=t1 - t0, preprocess_s=t2 - t1, odometry_s=t3 - t2,
                      surf=surf_t, surf_valid=surf_valid_t, odom=outs)
    surf = surf_t.cpu().numpy()
    surf_valid = surf_valid_t.cpu().numpy()
    is_kf = outs.is_keyframe.cpu().numpy()
    kf_idx = np.nonzero(is_kf)[0]
    T = len(kf_idx)
    if T < 2:
        raise ValueError("fewer than 2 keyframes selected")

    # 3. IMU interval binning (interval i: (kf_time[i-1], kf_time[i]]).
    # When an interval holds more samples than the NI budget, the run is
    # DECIMATED — group-averaged acc/gyr with group-summed dt — never
    # truncated: a truncated run would integrate only part of the
    # interval and leave a systematic (0.5·g·Δt² -scale) residual on
    # every IMU edge of exactly the long-gap real-bag intervals.
    kf_time = scan_time[kf_idx]
    acc_b = np.zeros((T, NI, 3))
    gyr_b = np.zeros((T, NI, 3))
    dt_b = np.zeros((T, NI))
    val_b = np.zeros((T, NI), bool)
    for i in range(1, T):
        m = (imu_time > kf_time[i - 1]) & (imu_time <= kf_time[i])
        sel = np.nonzero(m)[0]
        n_raw = len(sel)
        if n_raw == 0:
            continue
        ts = np.concatenate([[kf_time[i - 1]], imu_time[sel]])
        dts = np.diff(ts)
        if n_raw <= NI:
            n = n_raw
            acc_b[i, :n] = imu_acc[sel]
            gyr_b[i, :n] = imu_gyr[sel]
            dt_b[i, :n] = dts
        else:
            bounds = np.linspace(0, n_raw, NI + 1).round().astype(int)
            for g_ in range(NI):
                a, b = bounds[g_], max(bounds[g_ + 1], bounds[g_] + 1)
                acc_b[i, g_] = imu_acc[sel[a:b]].mean(0)
                gyr_b[i, g_] = imu_gyr[sel[a:b]].mean(0)
                dt_b[i, g_] = dts[a:b].sum()
            n = NI
        val_b[i, :n] = True

    # 4. Initial attitude by gravity alignment (Utility::g2R parity:
    # rotate the mean initial specific force onto +z, zero the yaw).
    i0 = imu_time <= kf_time[0]
    acc0_mean = (imu_acc[i0].mean(0) if i0.any() else imu_acc[0])
    g_dir = acc0_mean / max(np.linalg.norm(acc0_mean), 1e-9)
    zaxis = np.array([0.0, 0.0, 1.0])
    axis = np.cross(g_dir, zaxis)
    s = np.linalg.norm(axis)
    if s < 1e-9:
        q0 = np.array([1.0, 0, 0, 0])
    else:
        ang = np.arctan2(s, float(g_dir @ zaxis))
        q0 = quat.exp(torch.from_numpy(axis / s * ang)).numpy()
    j0 = int(np.searchsorted(imu_time, kf_time[0]))
    j0 = min(max(j0, 0), len(imu_time) - 1)

    # 5. Dense (non-key) frame channel from the odometry relatives
    # (/each_odom parity → optimizeLocalGraph input).
    rel_p = outs.rel_p.cpu().numpy()
    rel_q = outs.rel_q.cpu().numpy()
    dense_dp = np.zeros((T - 1, max_dense + 1, 3))
    dense_dq = np.zeros((T - 1, max_dense + 1, 4))
    dense_dq[..., 0] = 1.0
    dense_ok = np.zeros((T - 1, max_dense + 1), bool)
    dense_t = np.zeros((T - 1, max_dense))
    for k in range(T - 1):
        frames = list(range(kf_idx[k] + 1, kf_idx[k + 1] + 1))
        hops = frames[: max_dense + 1]
        # If more interior frames than the budget, merge the tail hops
        # into the last slot by composing the relatives.
        for h, fr in enumerate(hops):
            if h == len(hops) - 1 and frames[-1] != fr:
                dp = rel_p[fr].copy()
                dq = rel_q[fr].copy()
                for fr2 in frames[h + 1:]:
                    dq_t = torch.from_numpy(dq)
                    dp = dp + quat.rotate(dq_t, torch.from_numpy(rel_p[fr2])).numpy()
                    dq = quat.mul(dq_t, torch.from_numpy(rel_q[fr2])).numpy()
                dense_dp[k, h] = dp
                dense_dq[k, h] = dq
            else:
                dense_dp[k, h] = rel_p[fr]
                dense_dq[k, h] = rel_q[fr]
            dense_ok[k, h] = True
            if h < max_dense and h < len(hops) - 1:
                dense_t[k, h] = scan_time[fr]

    return Episode(
        kf_time=kf_time,
        imu_acc=acc_b, imu_gyr=gyr_b, imu_dt=dt_b, imu_valid=val_b,
        scan=surf[kf_idx], scan_valid=surf_valid[kf_idx],
        p0=np.zeros(3), q0=np.asarray(q0), v0=np.zeros(3),
        acc0=imu_acc[j0], gyr0=imu_gyr[j0],
        dense_rel_dp=dense_dp, dense_rel_dq=dense_dq,
        dense_rel_valid=dense_ok, dense_time=dense_t,
    )


def episode_from_rosbag(path: str, cfg: GlioConfig = GlioConfig(),
                        points_topic: str = "/velodyne_points",
                        imu_topic: str = "/imu/data",
                        max_scans: Optional[int] = None,
                        n_cols: int = 900,
                        verbose: bool = False,
                        device="cuda",
                        record: Optional[dict] = None) -> Episode:
    """ROS1 bag → Episode (the reference's exact input topics,
    Preprocessing.cpp:133-138); ``record`` as in ``episode_from_streams``,
    plus the bag's ``read_s``."""
    t0 = time.perf_counter()
    _, msgs = read_bag(path, topics=[points_topic, imu_topic])
    scan_time, scans, rings = [], [], []
    it, ia, ig = [], [], []
    for topic, typ, t, raw in msgs:
        if topic == points_topic:
            if max_scans is not None and len(scans) >= max_scans:
                continue
            st, flds = parse_pointcloud2(raw)
            if "xyz" not in flds:
                continue
            scan_time.append(st if st > 0 else t)
            scans.append(flds["xyz"])
            rings.append(flds.get("ring"))
        else:
            st, _, gyr, acc = parse_imu(raw)
            it.append(st if st > 0 else t)
            ia.append(acc)
            ig.append(gyr)
    if not scans or not it:
        raise ValueError(f"{path}: no {points_topic}/{imu_topic} messages")
    if record is not None:
        record["read_s"] = time.perf_counter() - t0
    have_rings = all(r is not None for r in rings)
    return episode_from_streams(
        cfg, np.asarray(scan_time), scans, np.asarray(it),
        np.asarray(ia), np.asarray(ig),
        rings=rings if have_rings else None, n_cols=n_cols,
        verbose=verbose, device=device, record=record)


def episode_from_pcd_dir(scan_glob: str, imu_csv: str,
                         cfg: GlioConfig = GlioConfig(),
                         n_cols: int = 900,
                         verbose: bool = False,
                         device="cuda") -> Episode:
    """PCD sequence + IMU CSV → Episode.

    Scans: PCD files whose sorted filenames embed the timestamp
    (``<t>.pcd``). IMU CSV rows: ``t, ax, ay, az, gx, gy, gz``.
    """
    paths = sorted(glob_mod.glob(scan_glob))
    if not paths:
        raise ValueError(f"no scans match {scan_glob}")
    scan_time = np.array(
        [float(os.path.splitext(os.path.basename(p))[0]) for p in paths])
    scans = [read_pcd(p) for p in paths]
    rows = np.loadtxt(imu_csv, delimiter=",")
    return episode_from_streams(
        cfg, scan_time, scans, rows[:, 0], rows[:, 1:4], rows[:, 4:7],
        n_cols=n_cols, verbose=verbose, device=device)
