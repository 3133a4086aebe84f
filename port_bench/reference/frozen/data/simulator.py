"""Deterministic LiDAR/IMU/GNSS episode simulator, numpy only: the benchmark's traffic.

A frozen copy of ``PlaneWorld``, ``simulate_episode``,
``simulate_gnss_epochs`` and ``drifted_trajectory`` of the port's
``data/simulator.py``, so that a change to the program cannot change the
traffic.

Ground truth is propagated by the same midpoint scheme the estimator
integrates with, so noise-free, bias-free IMU reproduces it to f64
round-off. ``circle_omega`` (a closed circular drive) feeds loop closure,
``dense_frames`` (the dense non-key frame channel) the local graph.
"""

import numpy as np

from ..factors.imu import ImuParams
from ..gnss import dd as dd_mod
from ..utils import coords as C
from .episode import Episode, GnssEpochs


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
    circle_omega=None,
    dense_frames=0,
    dense_noise=0.01,
    return_dense_gt=False,
) -> Episode:
    """Build a fully-consistent synthetic episode (see module docstring).

    ``circle_omega``: yaw rate (rad/s) of a closed circular drive, radius
    speed/ω, back at the start after 2π/ω seconds. ``dense_frames``:
    interior non-key frames per keyframe segment, as noisy relative-pose
    hops (the reference's 10 Hz ``/each_odom`` channel). With
    ``return_dense_gt`` also returns the IMU-rate truth
    ``{"t", "p", "q", "kf_idx", "world"}``."""
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
    if circle_omega is not None:
        # Constant yaw rate and centripetal world acceleration:
        # v(t) = speed·(cos ωt, sin ωt, 0).
        w = float(circle_omega)
        omega_true = np.tile([0.0, 0.0, w], (n_imu, 1))
        acc_w_true = speed * w * np.stack(
            [-np.sin(w * t_imu), np.cos(w * t_imu), np.zeros_like(t_imu)], -1)

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

    # Dense (non-key) frames: hop 0 leaves the left keyframe, the last hop
    # lands on the right one (``local_graph.interpolate_segments``).
    dense_kw = {}
    if dense_frames > 0:
        D = dense_frames
        drng = np.random.default_rng(seed * 31 + 7)
        rel_dp = np.zeros((T - 1, D + 1, 3))
        rel_dq = np.zeros((T - 1, D + 1, 4))
        rel_dq[..., 0] = 1.0
        rel_valid = np.ones((T - 1, D + 1), bool)
        dense_t = np.zeros((T - 1, D))
        for k in range(T - 1):
            sub = np.linspace(kf_idx[k], kf_idx[k + 1], D + 2).round().astype(int)
            dense_t[k] = t_imu[sub[1:-1]]
            for h in range(D + 1):
                a, b = sub[h], sub[h + 1]
                qa, qb = qs[a], qs[b]
                dp = _quat_rotmat(qa).T @ (ps[b] - ps[a])
                dq = _quat_mul(_quat_conj(qa), qb)
                rel_dp[k, h] = dp + dense_noise * drng.normal(size=3)
                ang = dense_noise * 0.1 * drng.normal(size=3)
                rel_dq[k, h] = _quat_mul(dq, _delta_q(ang))
                rel_dq[k, h] /= np.linalg.norm(rel_dq[k, h])
        dense_kw = dict(dense_rel_dp=rel_dp, dense_rel_dq=rel_dq,
                        dense_rel_valid=rel_valid, dense_time=dense_t)

    ep = Episode(
        kf_time=t_kf,
        imu_acc=imu_acc, imu_gyr=imu_gyr, imu_dt=imu_dts, imu_valid=imu_val,
        scan=scan, scan_valid=scan_valid,
        p0=ps[0], q0=qs[0], v0=vs[0],
        acc0=acc_out[0], gyr0=gyr_out[0],
        gt_p=ps[kf_idx], gt_q=qs[kf_idx], gt_v=vs[kf_idx],
        **dense_kw,
    )
    if return_dense_gt:
        return ep, {"t": t_imu, "p": ps, "q": qs, "kf_idx": kf_idx, "world": world}
    return ep


def simulate_gnss_epochs(gt_p_enu, kf_time, anchor_ecef, station_ecef,
                         n_sats=20, psr_noise=0.5, epoch_stride=3, seed=0,
                         max_sv=32, carrier=False, car_noise=0.005,
                         slip_prob=0.0, amb_cycles_lambda=None):
    """Synthetic DD-ready GNSS epochs for a simulated trajectory.

    Satellites on a slowly rotating shell; rover raw pseudoranges include
    the receiver clock, the Sagnac term and noise; station observations are
    exact, with no atmosphere, so DD is exact up to ``psr_noise``. One epoch
    every ``epoch_stride`` keyframes, 0.01 s after it.

    With ``carrier=True`` also the carrier channel: rover carrier =
    geometry + clock + per-arc ambiguity + ``car_noise``; cycle slips per
    (epoch, satellite) with ``slip_prob``, flagged in ``lli``. Doppler is
    always the true range rate plus the receiver clock drift.
    """
    rng = np.random.default_rng(seed)
    anchor_ecef = np.asarray(anchor_ecef, float)
    station_ecef = np.asarray(station_ecef, float)
    gt_ecef = C.enu2ecef_np(gt_p_enu, anchor_ecef)
    up = anchor_ecef / np.linalg.norm(anchor_ecef)
    # Random sky directions biased upward.
    dirs = rng.normal(size=(n_sats, 3))
    dirs += 1.2 * up
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    omega = rng.normal(size=(n_sats, 3)) * 1e-4     # slow drift rad/s

    idx = np.arange(0, len(kf_time), epoch_stride)
    E = len(idx)
    OMGE, CL = C.OMGE, C.CLIGHT
    g = GnssEpochs(
        time=np.asarray(kf_time)[idx] + 0.01,
        sat_pos=np.zeros((E, max_sv, 3)), sat_vel=np.zeros((E, max_sv, 3)),
        sat_ddt=np.zeros((E, max_sv)),
        psr_rov=np.zeros((E, max_sv)), psr_sta=np.zeros((E, max_sv)),
        psr_rov_corr=np.zeros((E, max_sv)), dopp_rov=np.zeros((E, max_sv)),
        elevation=np.zeros((E, max_sv)), snr=np.zeros((E, max_sv)),
        valid=np.zeros((E, max_sv), bool),
        system=np.zeros((E, max_sv), np.int8),
        master=np.full((E, 4), -1, np.int32),
        car_rov=np.zeros((E, max_sv)),
        car_sta=np.zeros((E, max_sv)),
        car_valid=np.zeros((E, max_sv), bool),
        lli=np.zeros((E, max_sv), np.int8),
        sat_id=np.full((E, max_sv), -1, np.int32),
    )
    kf_time = np.asarray(kf_time, float)
    # Ground-truth rover velocity (central differences over keyframes).
    v_ecef = np.gradient(gt_ecef, kf_time, axis=0)
    # Per-arc ambiguities: free-floating metres, or integer multiples of
    # the carrier wavelength ``amb_cycles_lambda``.
    if amb_cycles_lambda is not None:
        amb = amb_cycles_lambda * rng.integers(-150, 150, size=n_sats).astype(float)
    else:
        amb = 30.0 * rng.normal(size=n_sats)

    def shell(tt):
        d = dirs + np.cross(omega * tt, dirs)
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        return anchor_ecef + 2.2e7 * d

    for e, k in enumerate(idx):
        t = g.time[e] - g.time[0]
        rov = gt_ecef[min(k, len(gt_ecef) - 1)]
        vr = v_ecef[min(k, len(gt_ecef) - 1)]
        clk = 1e-3 * CL * (1 + 1e-8 * t)  # receiver clock (m)
        clk_drift = 1e-3 * CL * 1e-8      # m/s
        sats = shell(t)
        # Finite-difference velocity, so Doppler agrees with the positions.
        svel = shell(t + 0.5) - shell(t - 0.5)
        _, els = C.azel_np(rov, sats)
        for s in range(n_sats):
            sat = sats[s]
            el = float(els[s])
            if el < np.deg2rad(15):
                continue
            rho_u = np.linalg.norm(sat - rov)
            rho_s = np.linalg.norm(sat - station_ecef)
            sag_u = OMGE / CL * (sat[0] * rov[1] - sat[1] * rov[0])
            sag_s = OMGE / CL * (sat[0] * station_ecef[1]
                                 - sat[1] * station_ecef[0])
            g.sat_pos[e, s] = sat
            g.sat_vel[e, s] = svel[s]
            g.psr_rov[e, s] = rho_u + sag_u + clk + psr_noise * rng.normal()
            g.psr_sta[e, s] = rho_s + sag_s
            g.elevation[e, s] = el
            g.snr[e, s] = 45.0
            g.system[e, s] = 0 if s < n_sats // 2 else 3
            g.valid[e, s] = True
            g.sat_id[e, s] = int(g.system[e, s]) * 100 + s + 1
            los = (rov - sat) / rho_u
            sag_rate = OMGE / CL * (
                svel[s][0] * rov[1] + sat[0] * vr[1]
                - svel[s][1] * rov[0] - sat[1] * vr[0])
            g.dopp_rov[e, s] = np.dot(vr - svel[s], los) + sag_rate + clk_drift
            if carrier:
                if rng.uniform() < slip_prob and e > 0:
                    amb[s] = (amb_cycles_lambda * float(rng.integers(-150, 150))
                              if amb_cycles_lambda is not None
                              else 30.0 * rng.normal())
                    g.lli[e, s] = 1
                g.car_rov[e, s] = (rho_u + sag_u + clk + amb[s]
                                   + car_noise * rng.normal())
                g.car_sta[e, s] = rho_s + sag_s
                g.car_valid[e, s] = True
        g.master[e] = dd_mod.select_master(g.elevation[e], g.valid[e], g.system[e])
    return g


def drifted_trajectory(n_keyframes, max_drift=6.0):
    """A 3 Hz drive and its smoothly drifting odometry, for the batch stage.

    The trajectory of the JAX package's batch tests (``tests/test_batch.py``:
    x = 40·θ, y = 15·sin θ, z = 0.5·θ, θ advancing 3/119 rad per keyframe,
    heading 0.3·dy/dx), carried to any length. The odometry drifts
    quadratically in time, to ``max_drift`` m along x at the last keyframe
    (and 0.6 and 0.4 of that along −y and z), as the tests' drift does.

    Returns (kf_time, p_true, q_true, p_odo), numpy f64.
    """
    k = np.arange(n_keyframes, dtype=float)
    kf_time = k / 3.0
    th = k * (3.0 / 119.0)
    p_true = np.stack([40 * th, 15 * np.sin(th), 0.5 * th], -1)
    yaw = np.gradient(p_true[:, 1], p_true[:, 0] + 1e-9) * 0.3
    q_true = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], -1)
    s = (k / max(n_keyframes - 1, 1)) ** 2
    p_odo = p_true + max_drift * s[:, None] * np.array([1.0, -0.6, 0.4])
    return kf_time, p_true, q_true, p_odo
