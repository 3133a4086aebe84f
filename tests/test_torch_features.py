"""Port parity: LOAM features (``lidar/features.py``), ``quat.slerp`` and the
preprocessor (``models/preprocessing.py``) against the JAX package on the
same inputs.

Tolerances: masks, rings and the feature clouds equal; the curvature
c = ‖a‖² to 2‖a‖δ + δ², δ = 12 f32 ulps of 10·max|p| (XLA's CPU fuses the
roll sums a = −10·p₀ + Σ p_j with FMAs, and at 60 m the cancellation leaves
those ulps; the port adds in IEEE order, as the card does); slerp and
deskew to 1e-12 in f64 and 1e-6 in f32 (the JAX package's f32 trig is
XLA's own).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glio_tpu.config import GlioConfig
from glio_tpu.data.simulator import PlaneWorld, raycast_scan
from glio_tpu.lidar import features as jf
from glio_tpu.models.preprocessing import make_preprocessor as jax_preprocessor
from glio_tpu.utils import quat as jquat
from glio_tpu_torch import convert
from glio_tpu_torch.lidar import features as tf
from glio_tpu_torch.models.preprocessing import make_preprocessor
from glio_tpu_torch.utils import quat as tquat

MASKS = ("sharp", "less_sharp", "flat", "less_flat")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Long chains of small torch ops: one intra-op thread is as fast, and
    keeps a parallel test run's workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def synthetic_scan(R=8, P=360):
    """``tests/test_lidar.py::TestFeatures._synthetic_scan``: rings over flat
    ground and one wall whose range step makes curvature spikes."""
    az = np.linspace(-np.pi, np.pi, P, endpoint=False)
    pts = np.zeros((R, P, 3), np.float32)
    for r in range(R):
        rad = 8.0 + 0.5 * r
        pts[r, :, 0] = rad * np.cos(az)
        pts[r, :, 1] = rad * np.sin(az)
        pts[r, :, 2] = -1.5
    wall = (az > 0.3) & (az < 0.8)
    pts[:, wall, :] *= 0.5
    return pts, np.ones((R, P), bool)


def raycast_frame(seed, extent=120.0, n_walls=120, rings=16, cols=360):
    world = PlaneWorld(extent=extent, n_walls=n_walls, seed=seed)
    return raycast_scan(world, np.zeros(3), np.eye(3), n_rings=rings, n_cols=cols,
                        rng=np.random.default_rng(seed))


# name: (points, valid) maker, masks whose picks are near-ties. On the
# synthetic scan's perfect circles the flat curvatures agree to their last
# bits, so which flats win is rounding; there the flats are held per
# (ring, sextant) in number and as points below the flat threshold.
FRAMES = {"synthetic": (synthetic_scan, {"flat"}),
          "raycast_16x360": (lambda: raycast_frame(3), set())}


@pytest.mark.parametrize("n_scans", [16, 32, 64])
def test_ring_from_elevation(n_scans):
    rng = np.random.default_rng(n_scans)
    el = rng.uniform(-0.6, 0.3, 4000)
    az = rng.uniform(-np.pi, np.pi, 4000)
    r = rng.uniform(3.0, 80.0, 4000)
    pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)],
                   -1).astype(np.float32)
    ring_j, ok_j = jf.ring_from_elevation(jnp.asarray(pts), n_scans)
    ring_t, ok_t = tf.ring_from_elevation(torch.from_numpy(pts), n_scans)
    np.testing.assert_array_equal(ring_t.numpy(), np.asarray(ring_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert 0 < ok_t.sum() < 4000


def test_ring_from_elevation_rejects_other_models():
    with pytest.raises(ValueError):
        tf.ring_from_elevation(torch.zeros((1, 3)), 40)


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_extract_features_matches_jax(frame):
    make, tied = FRAMES[frame]
    pts, valid = make()
    oj = jf.extract_features(jnp.asarray(pts), jnp.asarray(valid))
    ot = tf.extract_features(torch.from_numpy(pts), torch.from_numpy(valid))
    R, P = valid.shape
    for k in MASKS:
        got, want = ot[k].numpy(), np.asarray(oj[k])
        if k in tied:
            per = lambda m: m[:, :P // 6 * 6].reshape(R, 6, -1).sum(-1)   # noqa: E731
            np.testing.assert_array_equal(per(got), per(want), err_msg=k)
            assert (ot["curvature"].numpy()[got] < 0.1).all()
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    c_t, c_j = ot["curvature"].numpy(), np.asarray(oj["curvature"])
    delta = 12 * 10 * np.abs(pts).max() * 2.0**-23
    tol = 2 * np.sqrt(np.maximum(c_j, 0)) * delta + delta**2
    assert (np.abs(c_t - c_j) <= tol).all(), np.abs(c_t - c_j).max()
    assert ot["sharp"].any() and ot["flat"].any() and ot["less_flat"].sum() > 100


def test_curvature_sums_in_ieee_order():
    """The port's curvature is numpy's, bit for bit: each roll added in
    turn, the squared norm as (x·x + y·y) + z·z (what the card computes)."""
    pts, valid = raycast_frame(5)
    c, ok = tf.curvature(torch.from_numpy(pts), torch.from_numpy(valid))
    acc = -10.0 * pts
    for off in range(1, 6):
        acc = acc + np.roll(pts, off, 1) + np.roll(pts, -off, 1)
    want = (acc[..., 0] * acc[..., 0] + acc[..., 1] * acc[..., 1]) + acc[..., 2] * acc[..., 2]
    np.testing.assert_array_equal(c.numpy()[ok.numpy()], want[ok.numpy()])
    assert (c.numpy()[~ok.numpy()] == -1.0).all()


def test_greedy_select_suppresses_neighbours():
    score = torch.tensor([[1.0, 5.0, 4.0, -np.inf, 3.0, 0.5, 2.0, 6.0]])
    picked = tf.greedy_select(score, 3, 1)
    # 6.0 at 7 (suppresses 6), then 5.0 at 1 (suppresses 0, 2), then 3.0 at 4.
    np.testing.assert_array_equal(picked[0].numpy(), [0, 1, 0, 0, 1, 0, 0, 1])
    assert not tf.greedy_select(torch.full((2, 4), -np.inf), 2, 1).any()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_slerp_matches_jax(dtype):
    rng = np.random.default_rng(4)
    q0 = rng.normal(size=(64, 4))
    q1 = rng.normal(size=(64, 4))
    q0 /= np.linalg.norm(q0, axis=-1, keepdims=True)
    q1 /= np.linalg.norm(q1, axis=-1, keepdims=True)
    q1[:4] = q0[:4]                                  # the lerp branch
    q1[4:8] = -q0[4:8]                               # the other hemisphere
    t = rng.uniform(size=(64, 1))
    q0, q1, t = (a.astype(dtype) for a in (q0, q1, t))
    want = np.asarray(jquat.slerp(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(t)))
    got = tquat.slerp(torch.from_numpy(q0), torch.from_numpy(q1), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 if dtype == np.float64 else 1e-6)


def test_deskew_matches_jax():
    rng = np.random.default_rng(6)
    pts = (rng.normal(size=(4, 90, 3)) * 10).astype(np.float64)
    rel = np.linspace(-0.1, 1.1, 360).reshape(4, 90)
    q_scan = jquat.normalize(jnp.asarray([0.99, 0.02, -0.05, 0.1]))
    q_lb = jquat.normalize(jnp.asarray([0.9, 0.1, 0.3, -0.2]))
    want = np.asarray(jf.deskew(jnp.asarray(pts), jnp.asarray(rel), q_scan, q_lb))
    got = tf.deskew(torch.from_numpy(pts), torch.from_numpy(rel),
                    torch.from_numpy(np.asarray(q_scan)), torch.from_numpy(np.asarray(q_lb)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    assert np.abs(want - pts).max() > 0.1                     # a real rotation


SURF_OUT = {"raycast_16x360_a": (3, 512), "raycast_16x360_b": (11, 512)}


@pytest.mark.parametrize("case", sorted(SURF_OUT))
def test_preprocessor_matches_jax(case):
    seed, surf_out = SURF_OUT[case]
    pts, valid = raycast_frame(seed)
    cfg = GlioConfig()
    want = jax_preprocessor(cfg, surf_out=surf_out)(jnp.asarray(pts), jnp.asarray(valid))
    got = make_preprocessor(convert.config_from_glio(cfg), "cpu", surf_out=surf_out)(pts, valid)
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.surf_valid.sum() > 100 and got.edge_valid.any() and got.flat_valid.any()


def test_surf_cloud_keeps_the_lowest_x_major_voxels():
    """The surf cloud's truncation quirk, copied from the JAX package: with
    more 0.4 m voxels than ``surf_out``, the voxels of lowest x-major key are
    kept, so the surf cloud loses the frame's high-x side."""
    pts, valid = raycast_frame(0, rings=32, cols=1800)
    cfg = convert.config_from_glio(GlioConfig())
    feats = tf.extract_features(torch.from_numpy(pts), torch.from_numpy(valid))
    less_flat = pts[feats["less_flat"].numpy()]
    keys = np.unique(np.floor(less_flat / np.float32(0.4) + 2048.0).astype(np.int64), axis=0)
    out = make_preprocessor(cfg, "cpu", surf_out=2048)(pts, valid)
    surf = out.surf.numpy()[out.surf_valid.numpy()]
    assert keys.shape[0] > 2048 and surf.shape[0] == 2048
    assert surf[:, 0].max() < less_flat[:, 0].max() - 10.0
    # Exactly the 2048 lowest voxel keys, in x-major order.
    kept = np.floor(surf / np.float32(0.4) + 2048.0).astype(np.int64)
    np.testing.assert_array_equal(kept, keys[:2048])
