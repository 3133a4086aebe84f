"""Port parity: raw-sensor ingest (``data/ingest.py``) against the JAX
package's, and the port's copy of the test bag writer.

The bags are ``tests/test_ingest.py``'s (its writer and its simulated
drives). Tolerances: the bag reader, decoders and ``organize_scan`` equal;
each ``Episode`` field equal, or within 1e-12 where it is host f64
arithmetic (IMU binning, the gravity alignment through ``quat.exp``); the
dense channel, which is the odometry's relatives, within 10× JAX's own
spread of those relatives under a ±1e-5 m nudge of the odometry's start
(``tests/test_torch_odometry.py`` says why).
"""

import dataclasses
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glio_tpu.config import GlioConfig, LidarOdometryConfig, ShapeConfig
from glio_tpu.data import ingest as jingest
from glio_tpu.data.simulator import PlaneWorld, raycast_scan, simulate_episode
from glio_tpu.eval.pointcloud import write_pcd
from glio_tpu.models import lidar_odometry as jlo
from glio_tpu.utils import quat as jquat
from glio_tpu_torch import convert, testing
from glio_tpu_torch.data import ingest
from test_ingest import _sim_to_bag, serialize_imu, serialize_pointcloud2, write_bag

CFG = GlioConfig().replace(
    shapes=ShapeConfig(max_imu_per_interval=40, scan_points=256, map_points=2048),
    lidar_odometry=LidarOdometryConfig(line_num=16))
EXACT = ("kf_time", "imu_valid", "scan", "scan_valid", "p0", "v0", "dense_rel_valid",
         "dense_time")
HOST_F64 = ("imu_acc", "imu_gyr", "imu_dt", "q0", "acc0", "gyr0")
NUDGE_M = 1e-5


def _messages(rng):
    xyz = (rng.normal(size=(100, 3)) * 10).astype(np.float32)
    ring = (np.arange(100) % 16).astype(np.uint16)
    scans = [(10.5, xyz, ring), (10.6, xyz[:40], None)]
    imu = [(10.4 + 0.01 * i, rng.normal(size=3), rng.normal(size=3)) for i in range(5)]
    return scans, imu


@pytest.mark.parametrize("compress", ["bz2", "none"])
def test_bag_writer_copy_is_byte_equal(tmp_path, compress):
    scans, imu = _messages(np.random.default_rng(0))
    for writer, name in ((write_bag, "a.bag"), (testing.write_bag, "b.bag")):
        ser_pc = serialize_pointcloud2 if writer is write_bag else testing.serialize_pointcloud2
        ser_imu = serialize_imu if writer is write_bag else testing.serialize_imu
        writer(str(tmp_path / name), [(t, ser_pc(t, x, r)) for t, x, r in scans],
               [(t, ser_imu(t, a, g)) for t, a, g in imu], compress)
    assert (tmp_path / "a.bag").read_bytes() == (tmp_path / "b.bag").read_bytes()


@pytest.mark.parametrize("compress", ["bz2", "none"])
def test_read_bag_and_decoders_match_jax(tmp_path, compress):
    scans, imu = _messages(np.random.default_rng(1))
    path = str(tmp_path / "t.bag")
    testing.write_bag(path, [(t, testing.serialize_pointcloud2(t, x, r)) for t, x, r in scans],
                      [(t, testing.serialize_imu(t, a, g)) for t, a, g in imu], compress)
    conns, msgs = ingest.read_bag(path)
    assert (conns, msgs) == jingest.read_bag(path)
    assert len(msgs) == 7 and {c["topic"] for c in conns.values()} == {
        "/velodyne_points", "/imu/data"}
    for (_, typ, _, raw), (t, x, r) in zip([m for m in msgs if "Point" in m[1]], scans):
        st, flds = ingest.parse_pointcloud2(raw)
        jst, jflds = jingest.parse_pointcloud2(raw)
        assert st == jst and abs(st - t) < 1e-6 and sorted(flds) == sorted(jflds)
        for k in flds:
            np.testing.assert_array_equal(flds[k], jflds[k])
        np.testing.assert_array_equal(flds["xyz"], x)
        assert ("ring" in flds) == (r is not None)
    for _, _, _, raw in (m for m in msgs if "Imu" in m[1]):
        for a, b in zip(ingest.parse_imu(raw), jingest.parse_imu(raw)):
            np.testing.assert_array_equal(a, b)
    assert len(ingest.read_bag(path, topics=["/imu/data"])[1]) == 5


def test_read_bag_rejects_other_files(tmp_path):
    path = tmp_path / "x.bag"
    path.write_bytes(b"not a bag")
    with pytest.raises(ValueError):
        ingest.read_bag(str(path))
    bag = tmp_path / "lz4.bag"
    bag.write_bytes(b"#ROSBAG V2.0\n" + testing._record(
        [(b"op", b"\x05"), (b"compression", b"lz4"), (b"size", struct.pack("<I", 0))], b""))
    with pytest.raises(NotImplementedError):
        ingest.read_bag(str(bag))


@pytest.mark.parametrize("rings", ["ring_field", "elevation_rings"])
def test_organize_scan_matches_jax(rings):
    world = PlaneWorld(extent=150.0, n_walls=80, seed=5)
    img, iv = raycast_scan(world, np.zeros(3), np.eye(3), n_rings=16, n_cols=360,
                           rng=np.random.default_rng(5))
    xyz = img[iv]
    ring = np.nonzero(iv)[0].astype(np.uint16) if rings == "ring_field" else None
    got = ingest.organize_scan(xyz, ring, 16, 360)
    want = jingest.organize_scan(xyz, ring, 16, 360)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[1].sum() > 1000


def _compare(ep_t, ep_j, surf, surf_valid, cfg):
    for f in EXACT:
        np.testing.assert_array_equal(getattr(ep_t, f), getattr(ep_j, f), err_msg=f)
    for f in HOST_F64:
        np.testing.assert_allclose(getattr(ep_t, f), getattr(ep_j, f), rtol=0, atol=1e-12,
                                   err_msg=f)
    run = jlo.make_odometry(cfg)
    base = run(jnp.asarray(surf), jnp.asarray(surf_valid))
    nudged = [run(jnp.asarray(surf), jnp.asarray(surf_valid), np.full(3, s * NUDGE_M))
              for s in (1, -1)]
    for f, key in (("dense_rel_dp", "rel_p"), ("dense_rel_dq", "rel_q")):
        spread = max(np.abs(np.asarray(getattr(r, key)) - np.asarray(getattr(base, key))).max()
                     for r in nudged)
        d = np.abs(getattr(ep_t, f) - getattr(ep_j, f)).max()
        assert d <= 10 * spread, (f, d, spread)
    a_w = jquat.rotate(jnp.asarray(ep_t.q0), jnp.asarray(ep_t.acc0))
    assert float(a_w[2]) > 9.0                        # gravity aligned onto +z


def test_episode_from_rosbag_matches_jax(tmp_path):
    path, _ = _sim_to_bag(tmp_path)
    ep_j = jingest.episode_from_rosbag(path, CFG, n_cols=360)
    rec = {}
    ep_t = ingest.episode_from_rosbag(path, convert.config_from_glio(CFG), n_cols=360,
                                      device="cpu", record=rec)
    assert ep_t.kf_time.shape[0] >= 3 and rec["odom"].is_keyframe.shape == (10,)
    # The front end ran on the device it was given.
    assert rec["surf"].device == torch.device("cpu") and rec["odom"].p.device.type == "cpu"
    assert set(rec) >= {"read_s", "organize_s", "preprocess_s", "odometry_s"}
    _compare(ep_t, ep_j, rec["surf"].numpy(), rec["surf_valid"].numpy(), CFG)
    assert ep_t.imu_valid[1:].any(axis=1).all()
    np.testing.assert_allclose(ep_t.imu_dt.sum(1)[1:], np.diff(ep_t.kf_time), atol=0.02)


def test_episode_from_pcd_dir_matches_jax(tmp_path):
    """``tests/test_ingest.py::test_episode_from_pcd_dir``'s drive."""
    T = 6
    ep = simulate_episode(n_keyframes=T, kf_dt=0.1, scan_points=256, seed=29,
                          q_lb=(1, 0, 0, 0), t_lb=(0, 0, 0))
    world = PlaneWorld(extent=max(200.0, np.abs(ep.gt_p).max() + 80.0), seed=29)
    for i in range(T):
        Rwb = np.asarray(jquat.to_rotmat(jnp.asarray(ep.gt_q[i])))
        img, iv = raycast_scan(world, ep.gt_p[i], Rwb, n_rings=16, n_cols=360,
                               rng=np.random.default_rng(200 + i))
        write_pcd(str(tmp_path / f"{1000 + ep.kf_time[i]:.3f}.pcd"), img[iv])
    rows = [np.concatenate([[1000.0 + ep.kf_time[i - 1] + np.cumsum(ep.imu_dt[i])[j]],
                            ep.imu_acc[i, j], ep.imu_gyr[i, j]])
            for i in range(1, T) for j in range(int(ep.imu_valid[i].sum()))]
    np.savetxt(str(tmp_path / "imu.csv"), np.asarray(rows), delimiter=",")
    args = (str(tmp_path / "*.pcd"), str(tmp_path / "imu.csv"))
    ep_j = jingest.episode_from_pcd_dir(*args, CFG, n_cols=360)
    ep_t = ingest.episode_from_pcd_dir(*args, convert.config_from_glio(CFG), n_cols=360,
                                       device="cpu")
    for f in dataclasses.fields(ep_t):
        a, b = getattr(ep_t, f.name), getattr(ep_j, f.name)
        assert (a is None) == (b is None), f.name
    for f in EXACT:
        np.testing.assert_array_equal(getattr(ep_t, f), getattr(ep_j, f), err_msg=f)
    for f in HOST_F64:
        np.testing.assert_allclose(getattr(ep_t, f), getattr(ep_j, f), rtol=0, atol=1e-12)
    assert ep_t.kf_time.shape[0] >= 2 and ep_t.scan_valid.any()


def test_imu_decimation_matches_jax(tmp_path):
    """``tests/test_ingest.py::test_imu_decimation_preserves_interval_span``:
    1 Hz scans at 100 Hz IMU, ~100 samples an interval against a budget of
    24, decimated (group means, group-summed dt), never truncated."""
    T = 4
    ep = simulate_episode(n_keyframes=T, kf_dt=1.0, scan_points=256, seed=41,
                          q_lb=(1, 0, 0, 0), t_lb=(0, 0, 0))
    world = PlaneWorld(extent=max(200.0, np.abs(ep.gt_p).max() + 80.0), seed=41)
    t0 = 2000.0
    scans = []
    for i in range(T):
        Rwb = np.asarray(jquat.to_rotmat(jnp.asarray(ep.gt_q[i])))
        img, iv = raycast_scan(world, ep.gt_p[i], Rwb, n_rings=16, n_cols=360,
                               rng=np.random.default_rng(300 + i))
        scans.append((t0 + ep.kf_time[i], testing.serialize_pointcloud2(t0 + ep.kf_time[i],
                                                                        img[iv])))
    path = str(tmp_path / "dec.bag")
    testing.write_bag(path, scans, testing.imu_messages(ep, t0))
    cfg = CFG.replace(shapes=ShapeConfig(max_imu_per_interval=24, scan_points=256,
                                         map_points=2048))
    ep_j = jingest.episode_from_rosbag(path, cfg, n_cols=360)
    ep_t = ingest.episode_from_rosbag(path, convert.config_from_glio(cfg), n_cols=360,
                                      device="cpu")
    for f in ("kf_time", "imu_valid", "scan", "scan_valid"):
        np.testing.assert_array_equal(getattr(ep_t, f), getattr(ep_j, f), err_msg=f)
    for f in ("imu_acc", "imu_gyr", "imu_dt"):
        np.testing.assert_allclose(getattr(ep_t, f), getattr(ep_j, f), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ep_t.imu_dt.sum(1)[1:], np.diff(ep_t.kf_time), atol=0.02)
    assert ep_t.imu_dt.shape[1] == 24 and (ep_t.imu_valid[1:].sum(1) == 24).any()
