"""Port parity: the window's ``diverse_select`` feature selection against
the JAX package's ``_associate``, replay and ``run_pipeline``.

Selection: the best F/2 by fit weight, then the best of each of 18 buckets
(dominant normal axis × azimuth sextant) over the rest. The buckets come
from an f32 ``arctan2`` and an ``argmax`` of |normal|, either of which can
flip between XLA and torch at a boundary; the test counts the flips and
holds the selected slots equal (there are none on these inputs). The
replay and the pipeline are held as ``tests/test_torch_sliding_window.py``
holds the default selection: n_lidar_factors equal at every step,
positions to 1e-4 m, quaternions to 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glio_tpu.config import EstimatorConfig, GlioConfig, ShapeConfig
from glio_tpu.data.simulator import PlaneWorld, raycast_scan, simulate_episode
from glio_tpu.lidar import neighbors as jneighbors
from glio_tpu.lidar import plane_fit as jplane_fit
from glio_tpu.models import sliding_window as jsw
from glio_tpu.models.preprocessing import make_preprocessor
from glio_tpu.pipeline import run_pipeline as jax_run_pipeline
from glio_tpu.solver.manifold import WindowState as JWindowState
from glio_tpu.utils import quat as jquat
from glio_tpu_torch import convert
from glio_tpu_torch.data.simulator import simulate_episode as port_simulate
from glio_tpu_torch.lidar import neighbors, plane_fit
from glio_tpu_torch.models.sliding_window import (SlidingWindowEstimator, _diverse_top,
                                                  make_replay)
from glio_tpu_torch.pipeline import run_pipeline
from glio_tpu_torch.solver.manifold import WindowState

BASE = GlioConfig().replace(
    shapes=ShapeConfig(max_imu_per_interval=40, scan_points=256, map_points=2048),
    estimator=EstimatorConfig(local_map_width=8, sw_max_iter=4))
CFG = BASE.replace(feature_selection=dataclasses.replace(BASE.feature_selection,
                                                         diverse_select=True))
TOL = {"p": 1e-4, "q": 1e-5}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def raycast_window():
    """Five 512-point surf clouds of 16 × 360 raycast frames along a 10 Hz
    drive, their true poses, and a 0.4 m map of the eight frames' world
    points (lidar = body: identity extrinsic)."""
    cfg = CFG.replace(shapes=ShapeConfig(scan_points=512, map_points=4096),
                      feature_selection=dataclasses.replace(CFG.feature_selection,
                                                            feature_res_num=120))
    ep = simulate_episode(n_keyframes=8, kf_dt=0.1, scan_points=256, seed=23, scan_noise=0.01,
                          q_lb=(1, 0, 0, 0), t_lb=(0, 0, 0))
    world = PlaneWorld(extent=max(200.0, np.abs(ep.gt_p).max() + 80.0), seed=23)
    pre = make_preprocessor(cfg, surf_out=512)
    surfs, valid = [], []
    for k in range(8):
        Rwb = np.asarray(jquat.to_rotmat(jnp.asarray(ep.gt_q[k])))
        img, iv = raycast_scan(world, ep.gt_p[k], Rwb, n_rings=16, n_cols=360,
                               rng=np.random.default_rng(100 + k))
        f = pre(jnp.asarray(img), jnp.asarray(iv))
        surfs.append(np.asarray(f.surf))
        valid.append(np.asarray(f.surf_valid))
    surfs, valid = np.stack(surfs), np.stack(valid)
    world_pts = np.asarray(jquat.rotate(jnp.asarray(ep.gt_q)[:, None], jnp.asarray(surfs,
                           jnp.float64)) + ep.gt_p[:, None]).astype(np.float32)
    mp, mv = neighbors.voxel_downsample(torch.from_numpy(world_pts.reshape(-1, 3)),
                                        torch.from_numpy(valid.reshape(-1)), 0.4, 4096,
                                        scatter_keys=True)
    # The window: frames 3-7, at poses a little off the truth.
    off = np.random.default_rng(2).normal(scale=0.03, size=(5, 3))
    return cfg, ep.gt_p[3:] + off, ep.gt_q[3:], surfs[3:], valid[3:], mp.numpy(), mv.numpy()


def test_associate_matches_jax(raycast_window):
    cfg, p, q, scans, valid, mp, mv = raycast_window
    K, S = scans.shape[:2]
    zeros = np.zeros((K, 3))
    win_j = JWindowState(p=jnp.asarray(p), q=jnp.asarray(q), v=jnp.asarray(zeros),
                         ba=jnp.asarray(zeros), bg=jnp.asarray(zeros))
    pts_j, nrm_j, d_j, score_j, mask_j = jsw._associate(
        cfg, win_j, jnp.asarray(scans), jnp.asarray(valid), jnp.asarray(mp), jnp.asarray(mv))
    est = SlidingWindowEstimator(convert.config_from_glio(cfg), "cpu")
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    win_t = WindowState(p=t(p), q=t(q), v=t(zeros), ba=t(zeros), bg=t(zeros))
    meas = est._associate(win_t, t(scans), t(valid), t(mp), t(mv))

    # The buckets on each side: azimuth sextants from each package's f32
    # arctan2, dominant axes from each package's plane normals on the same
    # neighbours (the port's association).
    world = est._to_world(t(scans), win_t.p, win_t.q).reshape(K * S, 3)
    _, idx = jneighbors.knn(jnp.asarray(world.numpy()), jnp.asarray(valid.reshape(-1)),
                            jnp.asarray(mp), jnp.asarray(mv), k=5)
    neigh = jneighbors.gather_neighbors(jnp.asarray(mp), idx)
    fit_j = jplane_fit.fit_planes(neigh, idx >= 0, jnp.asarray(world.numpy()),
                                  plane_tol=cfg.estimator.surf_dist_thres)
    fit_t = plane_fit.fit_planes(torch.from_numpy(np.asarray(neigh)),
                                 torch.from_numpy(np.asarray(idx >= 0)), world,
                                 plane_tol=cfg.estimator.surf_dist_thres)
    dom_flips = int((np.argmax(np.abs(np.asarray(fit_j.normal)), -1)
                     != torch.argmax(fit_t.normal.abs(), -1).numpy()).sum())
    az_j = np.asarray(jnp.arctan2(jnp.asarray(scans[..., 1]), jnp.asarray(scans[..., 0])))
    az_t = torch.atan2(t(scans[..., 1]), t(scans[..., 0])).numpy()
    def sextant(az):
        return np.clip((az + np.float32(np.pi)) / np.float32(np.pi / 3), 0, 5).astype(int)
    sect_flips = int((sextant(az_j) != sextant(az_t)).sum())
    print(f"bucket flips between XLA and torch: {dom_flips} dominant axes, "
          f"{sect_flips} sextants of {K * S} slots")

    np.testing.assert_array_equal(meas.mask.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(meas.points.numpy(), np.asarray(pts_j))
    m = np.asarray(mask_j)
    assert m.sum(1).min() > 60                          # real selections
    np.testing.assert_allclose(meas.score.numpy()[m], np.asarray(score_j)[m], rtol=1e-5)
    np.testing.assert_allclose(meas.normal.numpy()[m], np.asarray(nrm_j)[m], atol=1e-4)


def test_diverse_top_takes_half_globally_then_spreads():
    """F = 8 over one keyframe of 40 slots: the 4 best weights, then the
    best of the other slots spread over the buckets (sextants here), in
    the JAX package's order."""
    az = np.linspace(-np.pi + 0.05, np.pi - 0.05, 40)
    scans = torch.tensor(np.stack([np.cos(az), np.sin(az), np.zeros(40)], -1)[None],
                         dtype=torch.float32)
    normal = torch.zeros((1, 40, 3))
    normal[..., 2] = 1.0
    w = torch.linspace(0.4, 0.9, 40)[None]          # the best weights are all at high azimuth
    top_w, top_i = _diverse_top(w, normal, scans, 8)
    assert top_i[0, :4].tolist() == [39, 38, 37, 36]
    # The other four: each sextant's best, then the best of those.
    sext = np.clip((az + np.pi) / (np.pi / 3), 0, 5).astype(int)
    rest = [max(i for i in range(36) if sext[i] == s) for s in range(6)]
    assert sorted(top_i[0, 4:].tolist()) == sorted(rest)[-4:]
    assert top_w.shape == (1, 8)


def _replays(ep):
    replay_j, _ = jsw.make_replay(CFG)
    out_j = replay_j(ep.to_inputs(), ep.p0, ep.q0, ep.v0, ep.acc0, ep.gyr0)
    est = make_replay(convert.config_from_glio(CFG), "cpu")
    out_t = est(convert.inputs_from_numpy(ep.imu_acc, ep.imu_gyr, ep.imu_dt, ep.imu_valid,
                                          ep.scan, ep.scan_valid, ep.kf_time, device="cpu"),
                ep.p0, ep.q0, ep.v0, ep.acc0, ep.gyr0)
    return out_j, out_t


def test_replay_with_diverse_select_matches_jax():
    ep = simulate_episode(n_keyframes=6, scan_points=256, seed=1)
    out_j, out_t = _replays(ep)
    np.testing.assert_array_equal(out_t.n_lidar_factors.numpy(),
                                  np.asarray(out_j.n_lidar_factors))
    assert out_t.n_lidar_factors[-1] > 200
    for f, tol in TOL.items():
        np.testing.assert_allclose(getattr(out_t, f).numpy(), np.asarray(getattr(out_j, f)),
                                   rtol=0, atol=tol)


def test_run_pipeline_with_diverse_select(tmp_path):
    """Stage 1 of ``run_pipeline`` with ``diverse_select=True`` on the CPU,
    its ``tc_sw_result.csv`` against the JAX pipeline's."""
    kw = dict(n_keyframes=6, scan_points=256, seed=9)
    res_t = run_pipeline(port_simulate(**kw), convert.config_from_glio(CFG),
                         out_dir=str(tmp_path / "port"), device="cpu")
    jax_run_pipeline(simulate_episode(**kw), CFG, out_dir=str(tmp_path / "jax"))
    rows_t, rows_j = (np.loadtxt(tmp_path / d / "tc_sw_result.csv", delimiter=",", ndmin=2)
                      for d in ("port", "jax"))
    assert rows_t.shape == rows_j.shape == (6, 12)
    np.testing.assert_array_equal(rows_t[:, :3], rows_j[:, :3])
    np.testing.assert_allclose(rows_t[:, 9:12], rows_j[:, 9:12], rtol=0, atol=TOL["p"])
    assert np.isfinite(res_t.p_sw).all() and res_t.n_lidar_factors[-1] > 200
