"""Port parity: the scan-to-map LiDAR odometry (``models/lidar_odometry.py``)
against the JAX package's ``make_odometry``.

The inputs are ``tests/test_lidar.py::TestFullFrontendStack``'s: 8 frames
of 512-point surf clouds from 16 × 360 raycast range images at 10 Hz,
``local_map_frames=8``, ``max_num_iter=8``, started at the true pose.

Tolerances. The plane fits see the map's f32 world points, where JAX's
f32 covariances (FMA-fused by XLA's CPU) and the port's differ in the last
bits; near-degenerate fits turn those bits into different planes, and the
odometry carries the difference on. So the poses are held to 10× JAX's own
spread under a ±1e-5 m nudge of the start (the f32 resolution of the world
points), ``n_matches`` to that spread's own change of ``n_matches`` at each
frame, and the keyframe flags equal.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glio_tpu.config import GlioConfig, LidarOdometryConfig, ShapeConfig
from glio_tpu.data.simulator import PlaneWorld, raycast_scan, simulate_episode
from glio_tpu.models import lidar_odometry as jlo
from glio_tpu.models.preprocessing import make_preprocessor
from glio_tpu.utils import quat as jquat
from glio_tpu_torch import convert
from glio_tpu_torch.models.lidar_odometry import LidarOdometry, OdomCarry, make_odometry

NUDGE_M = 1e-5
CONFIGS = {
    # W·S = 8 × 512 = 4096 ≤ map_points: the raw map ring.
    "raw_map": GlioConfig().replace(
        shapes=ShapeConfig(scan_points=512),
        lidar_odometry=LidarOdometryConfig(local_map_frames=8, max_num_iter=8)),
    # 4096 > 2048: the ring is voxelled at 0.2 m with scattered keys.
    "voxelled_map": GlioConfig().replace(
        shapes=ShapeConfig(scan_points=512, map_points=2048),
        lidar_odometry=LidarOdometryConfig(local_map_frames=8, max_num_iter=8)),
}


@pytest.fixture(scope="module")
def drive():
    """(episode, surf clouds (8, 512, 3), masks) as TestFullFrontendStack makes them."""
    cfg = CONFIGS["raw_map"]
    ep = simulate_episode(n_keyframes=8, kf_dt=0.1, scan_points=256, seed=23, scan_noise=0.01,
                          q_lb=(1, 0, 0, 0), t_lb=(0, 0, 0))
    world = PlaneWorld(extent=max(200.0, np.abs(ep.gt_p).max() + 80.0), seed=23)
    pre = make_preprocessor(cfg, surf_out=512)
    surfs = np.zeros((8, 512, 3), np.float32)
    valid = np.zeros((8, 512), bool)
    for k in range(8):
        Rwb = np.asarray(jquat.to_rotmat(jnp.asarray(ep.gt_q[k])))
        img, iv = raycast_scan(world, ep.gt_p[k], Rwb, n_rings=16, n_cols=360,
                               rng=np.random.default_rng(100 + k))
        feats = pre(jnp.asarray(img), jnp.asarray(iv))
        surfs[k], valid[k] = np.asarray(feats.surf), np.asarray(feats.surf_valid)
    return ep, surfs, valid


def _spread(runs, base):
    dp = max(float(np.abs(np.asarray(r.p) - np.asarray(base.p)).max()) for r in runs)
    dn = np.max([np.abs(np.asarray(r.n_matches) - np.asarray(base.n_matches)) for r in runs], 0)
    return dp, dn


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_odometry_run_matches_jax(drive, name):
    ep, surfs, valid = drive
    cfg = CONFIGS[name]
    run_j = jlo.make_odometry(cfg)
    args = (jnp.asarray(surfs), jnp.asarray(valid))
    out_j = run_j(*args, ep.gt_p[0], ep.gt_q[0])
    nudged = [run_j(*args, ep.gt_p[0] + s * NUDGE_M, ep.gt_q[0]) for s in (1, -1)]
    spread_p, spread_n = _spread(nudged, out_j)

    out_t = make_odometry(convert.config_from_glio(cfg), "cpu")(surfs, valid, ep.gt_p[0],
                                                                ep.gt_q[0])
    np.testing.assert_array_equal(out_t.is_keyframe.numpy(), np.asarray(out_j.is_keyframe))
    dn = np.abs(out_t.n_matches.numpy() - np.asarray(out_j.n_matches))
    assert (dn <= spread_n).all(), (dn, spread_n)
    dp = np.abs(out_t.p.numpy() - np.asarray(out_j.p)).max()
    assert dp <= 10 * spread_p, (dp, spread_p)
    assert out_t.n_matches[-1] > 400


def _jax_step(cfg):
    """The JAX package's one-frame step: the ``lax.scan`` body that
    ``make_odometry``'s ``run`` closes over."""
    return inspect.getclosurevars(jlo.make_odometry(cfg).__wrapped__).nonlocals["step"]


def test_one_step_from_jax_carry(drive):
    """JAX runs 4 frames; its carry goes to the port through
    ``convert.odom_carry_from_numpy``, and the port's step of frame 4 is held
    against JAX's step from the same carry, within 10× JAX's own spread
    under a ±1e-5 m nudge of the map's poses."""
    ep, surfs, valid = drive
    cfg = CONFIGS["voxelled_map"]
    step_j = jax.jit(_jax_step(cfg))
    W, S = cfg.lidar_odometry.local_map_frames, cfg.shapes.scan_points
    f64 = jnp.float64
    ident = jnp.array([1.0, 0, 0, 0], f64)
    c0 = jlo.OdomCarry(
        p=jnp.asarray(ep.gt_p[0], f64), q=jnp.asarray(ep.gt_q[0], f64),
        rel_p=jnp.zeros(3, f64), rel_q=ident, kf_p=jnp.zeros(3, f64), kf_q=ident,
        map_scans=jnp.zeros((W, S, 3), jnp.float32), map_valid=jnp.zeros((W, S), bool),
        map_p=jnp.zeros((W, 3), f64), map_q=jnp.tile(ident, (W, 1)),
        map_slot_valid=jnp.zeros((W,), bool), map_head=jnp.asarray(0, jnp.int32),
        frames_since_kf=jnp.asarray(0, jnp.int32), frame_count=jnp.asarray(0, jnp.int32))
    carry, _ = jax.lax.scan(step_j, c0, (jnp.asarray(surfs[:4]), jnp.asarray(valid[:4])))
    frame = (jnp.asarray(surfs[4]), jnp.asarray(valid[4]))
    _, out_j = step_j(carry, frame)
    # The map's poses nudged: the plane fits see the f32 rounding move.
    nudged = [step_j(carry._replace(map_p=carry.map_p + s * NUDGE_M), frame)[1]
              for s in (1, -1)]
    spread_p, spread_n = _spread(nudged, out_j)

    tree = jax.tree.map(np.asarray, carry)
    carry_t = convert.odom_carry_from_numpy(tree, "cpu")
    assert isinstance(carry_t, OdomCarry) and carry_t.map_scans.dtype == torch.float32
    odo = LidarOdometry(convert.config_from_glio(cfg), "cpu")
    new_t, out_t = odo.step(carry_t, torch.from_numpy(surfs[4]), torch.from_numpy(valid[4]))
    assert bool(out_t.is_keyframe) == bool(out_j.is_keyframe)
    assert abs(int(out_t.n_matches) - int(out_j.n_matches)) <= spread_n
    dp = np.abs(out_t.p.numpy() - np.asarray(out_j.p)).max()
    assert dp <= 10 * spread_p, (dp, spread_p)
    assert int(new_t.frame_count) == 5 and int(new_t.map_head) == int(carry.map_head) + 1

    back = convert.odom_carry_to_numpy(carry_t)
    for f in OdomCarry._fields:
        np.testing.assert_array_equal(getattr(back, f), getattr(tree, f), err_msg=f)


def test_first_frame_searches_an_empty_map(drive):
    """Frame 0 runs its ICP rounds against the all-invalid map and keeps
    the start pose: no correspondences, no solve."""
    ep, surfs, valid = drive
    odo = make_odometry(convert.config_from_glio(CONFIGS["raw_map"]), "cpu")
    carry, out = odo.step(odo.initial_carry(ep.gt_p[0], ep.gt_q[0]),
                          torch.from_numpy(surfs[0]), torch.from_numpy(valid[0]))
    assert bool(out.is_keyframe) and int(out.n_matches) == 0
    np.testing.assert_array_equal(out.p.numpy(), ep.gt_p[0])
    assert int(carry.map_head) == 1 and bool(carry.map_slot_valid[0])
