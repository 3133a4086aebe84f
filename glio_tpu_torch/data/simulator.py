"""Deterministic LiDAR/IMU episode simulator, numpy only.

A copy of ``PlaneWorld`` and ``simulate_episode`` from
``glio_tpu/data/simulator.py``: the port cannot import the JAX package (its
``__init__`` imports jax). ``tests/test_torch_config_data.py`` holds the
arrays this module makes bit-identical to the JAX package's.

Ground truth is propagated by the same midpoint scheme the estimator
integrates with, so noise-free, bias-free IMU reproduces it to f64
round-off. Not copied yet: the circular drive (``circle_omega``) and the
dense non-key frame channel (``dense_frames``), which only the loop-closure
and local-graph stages use.
"""

import numpy as np

from ..factors.imu import ImuParams
from .episode import Episode

def _quat_mul(q1, q2):
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _quat_rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _delta_q(theta):
    half = 0.5 * np.asarray(theta)
    q = np.concatenate([[1.0], half])
    return q / np.linalg.norm(q)


def _quat_conj(q):
    return np.array([q[0], -q[1], -q[2], -q[3]])


class PlaneWorld:
    """A world of finite plane patches (building facades + ground)."""

    def __init__(self, extent=400.0, n_walls=160, seed=0, along=None):
        """`along`: optional (N, 3) trajectory — walls are then placed as a
        corridor flanking the path (urban-street geometry) instead of
        uniformly over the extent, so scene density is independent of how
        long the trajectory is (a fixed wall count spread over a huge
        bounding box starves long episodes of lateral constraints)."""
        rng = np.random.default_rng(seed + 1)
        if along is not None:
            along = np.asarray(along, float)
            # One wall every ~5 m of path on average, at least n_walls.
            seg = np.linalg.norm(np.diff(along, axis=0), axis=-1)
            n_walls = max(n_walls, int(seg.sum() / 5.0))
            picks = along[rng.integers(0, along.shape[0], size=n_walls)]
            lateral = rng.uniform(6.0, 25.0, size=n_walls)
            side = rng.choice([-1.0, 1.0], size=n_walls)
            theta = rng.uniform(0, 2 * np.pi, size=n_walls)
            offs = np.stack([np.cos(theta), np.sin(theta)], -1)
            centers = picks.copy()
            centers[:, :2] += offs * (side * lateral)[:, None]
        else:
            centers = rng.uniform(-extent, extent, size=(n_walls, 3))
        yaw = rng.uniform(0, np.pi, size=n_walls)
        normals = np.stack([np.cos(yaw), np.sin(yaw), np.zeros(n_walls)], -1)
        half = rng.uniform(4.0, 15.0, size=(n_walls, 2))  # width, height
        # Keep walls above the ground plane (z=-1.8) so patches don't
        # interpenetrate — false cross-plane correspondences otherwise.
        centers[:, 2] = -1.5 + half[:, 1]
        # Ground plane last.
        self.centers = np.concatenate([centers, [[0.0, 0.0, -1.8]]])
        self.normals = np.concatenate([normals, [[0.0, 0.0, 1.0]]])
        self.half = np.concatenate([half, [[1e6, 1e6]]])
        t1 = np.cross(self.normals, [0, 0, 1.0])
        n_t1 = np.linalg.norm(t1, axis=-1)
        vertical = n_t1 < 1e-6
        t1[vertical] = np.array([1.0, 0, 0])
        t1 /= np.linalg.norm(t1, axis=-1, keepdims=True)
        self.t1 = t1
        self.t2 = np.cross(self.normals, t1)

    def sample_scan(self, p_w, R_wb, n_points, max_range=60.0, noise=0.02,
                    rng=None):
        """Sample body-frame points on plane patches near the sensor.

        Not a raycast (no occlusion) — the estimator only needs points that
        genuinely lie on world planes with realistic density/noise.
        """
        rng = rng or np.random.default_rng(0)
        n_ground = int(n_points * 0.4)
        n_wall = n_points - n_ground

        # Nearest few walls get all the wall returns, concentrated around
        # the footpoint closest to the sensor — mimicking a real scan's
        # density falloff so 5-NN neighborhoods are genuinely local.
        d_c = np.linalg.norm(self.centers[:-1] - p_w, axis=-1)
        order = np.argsort(d_c)
        near = order[d_c[order] < max_range][:6]
        pts = []
        if near.size:
            per_wall = n_wall // near.size
            for i in near:
                # In-plane coordinates of the sensor's closest point.
                rel = p_w - self.centers[i]
                a0 = np.array([rel @ self.t1[i], rel @ self.t2[i]])
                a = a0 + rng.normal(scale=3.0, size=(per_wall, 2))
                a = np.clip(a, -self.half[i], self.half[i])
                pts.append(self.centers[i] + a[:, :1] * self.t1[i]
                           + a[:, 1:] * self.t2[i])
        # Ground: radial density ~ 1/r like a spinning lidar.
        gi = len(self.centers) - 1
        r = 3.0 + 22.0 * rng.uniform(0, 1, size=n_ground) ** 2
        th = rng.uniform(0, 2 * np.pi, size=n_ground)
        gxy = p_w[:2] + np.stack([r * np.cos(th), r * np.sin(th)], -1)
        a = gxy - self.centers[gi, :2]
        pts.append(self.centers[gi] + a[:, :1] * self.t1[gi]
                   + a[:, 1:] * self.t2[gi])

        pts = np.concatenate(pts)
        if pts.shape[0] < n_points:
            reps = int(np.ceil(n_points / pts.shape[0]))
            pts = np.tile(pts, (reps, 1))
        pts = pts[:n_points]
        rngs = np.linalg.norm(pts - p_w, axis=-1)
        keep = rngs < max_range
        pts_b = (pts - p_w) @ R_wb
        pts_b += noise * rng.normal(size=pts_b.shape)
        return pts_b.astype(np.float32), keep


def simulate_episode(
    n_keyframes=120,
    kf_dt=1.0 / 3.0,
    imu_rate=100.0,
    scan_points=1024,
    params: ImuParams = ImuParams(),
    accel_bias=(0.02, -0.015, 0.01),
    gyro_bias=(0.002, -0.001, 0.0015),
    imu_noise=True,
    scan_noise=0.02,
    speed=5.0,
    seed=0,
    q_lb=(1.0, 0.0, 0.0, 0.0),
    t_lb=(0.0, 0.0, 0.28),
) -> Episode:
    """Build a fully-consistent synthetic episode (see module docstring)."""
    rng = np.random.default_rng(seed)
    T = n_keyframes
    imu_dt = 1.0 / imu_rate
    n_per = int(round(kf_dt / imu_dt))
    n_imu = T * n_per + 1
    t_imu = np.arange(n_imu) * imu_dt
    t_kf = np.arange(T) * kf_dt

    # Smooth true body-rate (yaw-dominant urban drive) and world-acc
    # profiles as sums of low-frequency sinusoids.
    def smooth_profile(scale, n_modes=4, key=0):
        r = np.random.default_rng(seed * 7919 + key)
        out = np.zeros_like(t_imu)
        for m in range(1, n_modes + 1):
            f = r.uniform(0.02, 0.15) * m
            out += r.normal() * np.sin(2 * np.pi * f * t_imu + r.uniform(0, 7))
        return scale * out / max(1, n_modes)

    omega_true = np.stack([
        smooth_profile(0.05, key=1),
        smooth_profile(0.05, key=2),
        smooth_profile(0.6, key=3),
    ], -1)                                     # body rates (rad/s)
    acc_w_true = np.stack([
        smooth_profile(1.2, key=4),
        smooth_profile(1.2, key=5),
        smooth_profile(0.3, key=6),
    ], -1)                                     # world-frame acceleration

    g = np.array([0.0, 0.0, params.gravity])
    ba = np.asarray(accel_bias, float)
    bg = np.asarray(gyro_bias, float)

    # Ideal specific-force / body-rate measurements at sample times.
    # R_wb evolves with the same midpoint quaternion update the estimator
    # uses; acc measurement at sample k is R_wb[k]ᵀ(a_w[k] + g).
    q = np.array([1.0, 0, 0, 0])
    p = np.zeros(3)
    v = np.array([speed, 0.0, 0.0])
    qs = np.zeros((n_imu, 4))
    ps = np.zeros((n_imu, 3))
    vs = np.zeros((n_imu, 3))
    acc_meas = np.zeros((n_imu, 3))
    gyr_meas = np.zeros((n_imu, 3))
    qs[0], ps[0], vs[0] = q, p, v
    R = _quat_rotmat(q)
    acc_meas[0] = R.T @ (acc_w_true[0] + g)
    gyr_meas[0] = omega_true[0]
    for k in range(1, n_imu):
        # Measurements (ideal) at sample k are defined w.r.t. the new
        # attitude; propagate attitude first with midpoint gyro.
        un_gyr = 0.5 * (omega_true[k - 1] + omega_true[k])
        q_new = _quat_mul(q, _delta_q(un_gyr * imu_dt))
        q_new /= np.linalg.norm(q_new)
        R_new = _quat_rotmat(q_new)
        acc_meas[k] = R_new.T @ (acc_w_true[k] + g)
        gyr_meas[k] = omega_true[k]
        # Midpoint velocity/position update exactly as the estimator does:
        un_acc = 0.5 * (R @ acc_meas[k - 1] + R_new @ acc_meas[k]) - g
        p = p + v * imu_dt + 0.5 * un_acc * imu_dt * imu_dt
        v = v + un_acc * imu_dt
        q, R = q_new, R_new
        qs[k], ps[k], vs[k] = q, p, v

    # Add bias + noise to the measurements (after truth is fixed).
    acc_out = acc_meas + ba
    gyr_out = gyr_meas + bg
    if imu_noise:
        # acc_n/gyr_n are DISCRETE per-sample sigmas here, matching both
        # the factor model (which follows the reference's convention of
        # plugging the config values straight into the per-sample noise
        # block, Preintegration.h:48-71) and, numerically, the real
        # Xsens MTi-10 the config describes.
        acc_out = acc_out + params.acc_n * rng.normal(size=acc_out.shape)
        gyr_out = gyr_out + params.gyr_n * rng.normal(size=gyr_out.shape)

    kf_idx = np.arange(T) * n_per
    NI = n_per + 4
    imu_acc = np.zeros((T, NI, 3))
    imu_gyr = np.zeros((T, NI, 3))
    imu_dts = np.zeros((T, NI))
    imu_val = np.zeros((T, NI), bool)
    for i in range(1, T):
        s, e = kf_idx[i - 1] + 1, kf_idx[i] + 1
        n = e - s
        imu_acc[i, :n] = acc_out[s:e]
        imu_gyr[i, :n] = gyr_out[s:e]
        imu_dts[i, :n] = imu_dt
        imu_val[i, :n] = True

    # LiDAR scans at keyframe poses.
    world = PlaneWorld(extent=max(200.0, np.abs(ps).max() + 80.0), seed=seed,
                       along=ps[kf_idx])
    scan = np.zeros((T, scan_points, 3), np.float32)
    scan_valid = np.zeros((T, scan_points), bool)
    for i in range(T):
        j = kf_idx[i]
        pts_b, keep = world.sample_scan(
            ps[j], _quat_rotmat(qs[j]), scan_points, noise=scan_noise,
            rng=np.random.default_rng(seed * 100003 + i))
        # Body → lidar frame, matching the estimator's extrinsic convention
        # p_b = q_lb⁻¹(p_l − t_lb)  ⇒  p_l = q_lb p_b + t_lb.
        R_lb = _quat_rotmat(np.asarray(q_lb, float))
        scan[i] = pts_b @ R_lb.T + np.asarray(t_lb, np.float32)
        scan_valid[i] = keep

    return Episode(
        kf_time=t_kf,
        imu_acc=imu_acc, imu_gyr=imu_gyr, imu_dt=imu_dts, imu_valid=imu_val,
        scan=scan, scan_valid=scan_valid,
        p0=ps[0], q0=qs[0], v0=vs[0],
        acc0=acc_out[0], gyr0=gyr_out[0],
        gt_p=ps[kf_idx], gt_q=qs[kf_idx], gt_v=vs[kf_idx],
    )
