"""Port parity: loop closure (``models/loop_closure.py``), the banded
Cholesky and Woodbury solves (``solver/banded.py``), the dense-frame
interpolation (``models/local_graph.py``), the map export
(``eval/pointcloud.py``) and ``dense.huber_weight``'s delta, against the
JAX package on the same numpy inputs.

Tolerances, each measured on these inputs with margin: the banded solves
1e-9 relative (f64 round-off of two factorizations); ``solve_with_loops``
1e-8 m; ``interpolate_segments`` 1e-8 m (JAX factors its LM steps in f32
with two f64 refinements, the port in f64); ``verify_loop`` 1e-4 m and
1e-5 on the quaternion, because its plane fits are f32 and XLA's CPU dot
contracts with FMAs (PERF.md, PR 1), with the accepted flag equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glio_tpu.config import EstimatorConfig as JEst
from glio_tpu.config import GlioConfig as JCfg
from glio_tpu.config import ShapeConfig as JShapes
from glio_tpu.data.simulator import simulate_episode as jax_simulate
from glio_tpu.eval import pointcloud as JP
from glio_tpu.models import local_graph as JG
from glio_tpu.models import loop_closure as JLC
from glio_tpu.solver import banded as JB
from glio_tpu.solver import dense as JD
from glio_tpu_torch import convert
from glio_tpu_torch.eval import pointcloud
from glio_tpu_torch.models import local_graph, loop_closure
from glio_tpu_torch.ops import knn as knn_mod
from glio_tpu_torch.solver import banded, dense
from glio_tpu_torch.utils import profiling

F64 = torch.float64
LC_CFG = JCfg().replace(
    shapes=JShapes(max_imu_per_interval=40, scan_points=256, map_points=4096),
    estimator=JEst(local_map_width=8, sw_max_iter=6, loop_closure_on=True,
                   lc_search_radius=15.0, lc_time_thres=10.0, lc_map_width=8,
                   lc_icp_thres=0.3))


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("delta", [1.0, 0.2])
def test_huber_weight_matches_jax(delta):
    r = np.random.default_rng(0).normal(scale=1.0, size=500)
    want = np.asarray(JD.huber_weight(jnp.asarray(r), delta))
    got = dense.huber_weight(torch.tensor(r), delta)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15)
    if delta == 1.0:                      # the window's callers pass no delta
        assert torch.equal(dense.huber_weight(torch.tensor(r)), got)


def _band_system(T=40, hw=2, D=6, seed=0):
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(T, 2 * hw + 1, D, D))
    band = np.zeros_like(J)
    band[:, hw] = np.einsum("tij,tkj->tik", J[:, hw], J[:, hw]) + 20 * np.eye(D)
    for o in range(1, hw + 1):
        blk = 0.4 * J[:T - o, hw + o]
        band[:T - o, hw + o] = blk
        band[o:, hw - o] = np.swapaxes(blk, -1, -2)
    return band, rng.normal(size=(T, D)), rng


def _dense(band):
    T, Bw, D, _ = band.shape
    hw = (Bw - 1) // 2
    H = np.zeros((T * D, T * D))
    for t in range(T):
        for o in range(Bw):
            c = t + o - hw
            if 0 <= c < T:
                H[t * D:(t + 1) * D, c * D:(c + 1) * D] = band[t, o]
    return H


@pytest.mark.parametrize("hw", [1, 2])
def test_direct_solve_matches_jax(hw):
    band, b, _ = _band_system(hw=hw)
    want = np.asarray(JB.direct_solve(jnp.asarray(band), jnp.asarray(b)))
    got = banded.direct_solve(_t(band), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())
    np.testing.assert_allclose(got.reshape(-1), np.linalg.solve(_dense(band), b.reshape(-1)),
                               rtol=0, atol=1e-9 * np.abs(want).max())
    Lb = banded.block_cholesky(_t(band))
    np.testing.assert_allclose(Lb.numpy(), np.asarray(JB.block_cholesky(jnp.asarray(band))),
                               rtol=0, atol=1e-12 * np.abs(band).max())


def test_woodbury_solve_matches_jax():
    band, b, rng = _band_system(hw=1)
    T, _, D, _ = band.shape
    J_extra = np.zeros((12, T, D))
    J_extra[:6, 3] = rng.normal(size=(6, D))
    J_extra[:6, 35] = rng.normal(size=(6, D))
    J_extra[6:, 10] = rng.normal(size=(6, D))
    J_extra[6:, 30] = rng.normal(size=(6, D))
    r_extra = rng.normal(size=12)
    want = np.asarray(JB.woodbury_solve(*(jnp.asarray(a) for a in (band, b, J_extra, r_extra))))
    got = banded.woodbury_solve(*(_t(a) for a in (band, b, J_extra, r_extra))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())
    Jf = J_extra.reshape(12, -1)
    exact = np.linalg.solve(_dense(band) + Jf.T @ Jf, b.reshape(-1) - Jf.T @ r_extra)
    np.testing.assert_allclose(got.reshape(-1), exact, rtol=0, atol=1e-9 * np.abs(exact).max())


@pytest.fixture(scope="module")
def circle():
    """The JAX loop-closure test's circular drive (66 keyframes, one circle
    in 22 s) with its smoothly growing injected drift."""
    T = 66
    ep = jax_simulate(n_keyframes=T, kf_dt=1.0 / 3.0, scan_points=256, seed=17,
                      circle_omega=2 * np.pi / (T / 3.0))
    ramp = (np.arange(T) / (T - 1))[:, None] ** 2
    return ep, ep.gt_p + ramp * np.array([0.5, -0.4, 3.0])


def test_detect_loops_matches_jax(circle):
    ep, p = circle
    est = LC_CFG.estimator
    kw = dict(search_radius=est.lc_search_radius, time_thresh=est.lc_time_thres)
    want = JLC.detect_loops(p, ep.kf_time, **kw)
    got = loop_closure.detect_loops(p, ep.kf_time, **kw)
    assert [tuple(c) for c in got] == [tuple(c) for c in want] and want


def test_verify_loop_matches_jax(circle):
    ep, p = circle
    est = LC_CFG.estimator
    c = JLC.detect_loops(p, ep.kf_time, est.lc_search_radius, est.lc_time_thres)[0]
    w = est.lc_map_width // 2
    j0, j1 = max(c.old - w, 0), min(c.old + w + 1, p.shape[0])
    args = (ep.scan[c.cur], ep.scan_valid[c.cur], ep.scan[j0:j1], ep.scan_valid[j0:j1],
            p[j0:j1], ep.gt_q[j0:j1], p[c.cur], ep.gt_q[c.cur])
    pj, qj, fj, okj = JLC.verify_loop(LC_CFG, *args)
    before = profiling.tallies().get("knn.launches", 0)
    pt, qt, ft, okt = loop_closure.verify_loop(convert.config_from_glio(LC_CFG),
                                               *(_t(a) for a in args))
    assert profiling.tallies().get("knn.launches", 0) == before   # the plain version on the CPU
    assert bool(okt) == bool(okj)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-4)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-3)
    assert np.linalg.norm(pt.numpy() - p[c.cur]) > 0.5        # the ICP moved the pose


def test_solve_with_loops_matches_jax(circle):
    ep, p = circle
    q = ep.gt_q
    # A loop edge from the truth: keyframe 60 seen from keyframe 2.
    i, j = 2, 60
    qi = jnp.asarray(q[i])
    from glio_tpu.utils import quat as jq
    dq = np.asarray(jq.mul(jq.conj(qi), jnp.asarray(q[j])))
    dp = np.asarray(jq.rotate(jq.conj(qi), jnp.asarray(ep.gt_p[j] - ep.gt_p[i])))
    edges = [(i, j, dp, dq), (5, 63, *(np.asarray(a) for a in (
        jq.rotate(jq.conj(jnp.asarray(q[5])), jnp.asarray(ep.gt_p[63] - ep.gt_p[5])),
        jq.mul(jq.conj(jnp.asarray(q[5])), jnp.asarray(q[63])))))]
    for e in (edges, []):
        pj, qj = JLC.solve_with_loops(p, q, e)
        pt, qt = loop_closure.solve_with_loops(_t(p), _t(q), e)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-8)
        np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=0, atol=1e-9)


def _dense_episode(short: bool):
    ep = jax_simulate(n_keyframes=8, scan_points=64, seed=19, dense_frames=3,
                      dense_noise=0.005)
    valid = ep.dense_rel_valid.copy()
    if short:
        # Segments 2 and 5 have 2 and 3 of their 4 hops: the last measured
        # hop lands on the right keyframe at chain position n_hops.
        for k, n in ((2, 2), (5, 3)):
            valid[k, n:] = False
    return ep, valid


@pytest.mark.parametrize("short", [False, True])
def test_interpolate_segments_matches_jax(short):
    ep, valid = _dense_episode(short)
    rng = np.random.default_rng(4)
    kf_p = ep.gt_p + rng.normal(scale=0.05, size=ep.gt_p.shape)
    kf_q = ep.gt_q
    args = (kf_p, kf_q, ep.dense_rel_dp, ep.dense_rel_dq, valid)
    pj, qj, vj = JG.interpolate_segments(*(jnp.asarray(a) for a in args), max_dense=3)
    pt, qt, vt = local_graph.interpolate_segments(*(_t(a) for a in args), max_dense=3)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=0, atol=1e-8)
    assert pt.shape == (7, 3, 3) and np.isfinite(pt.numpy()).all()


def test_assemble_map_and_write_pcd_match_jax(tmp_path):
    ep = jax_simulate(n_keyframes=7, scan_points=128, seed=33)
    rng = np.random.default_rng(2)
    p = ep.gt_p + rng.normal(scale=0.1, size=ep.gt_p.shape)
    kw = dict(every=2, ql2b=(0.9990482, 0.0, 0.0436194, 0.0), tl2b=(0.1, -0.05, 0.28))
    wj, vj = JP.assemble_map(ep.scan, ep.scan_valid, p, ep.gt_q, **kw)
    wt, vt = pointcloud.assemble_map(ep.scan, ep.scan_valid, p, ep.gt_q, **kw, device="cpu")
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(wt, np.asarray(wj), rtol=0, atol=1e-12)
    n_t = pointcloud.write_pcd(str(tmp_path / "t.pcd"), wt, vt)
    n_j = JP.write_pcd(str(tmp_path / "j.pcd"), np.asarray(wj), vj)
    assert n_t == n_j == int(vj.sum())
    assert (tmp_path / "t.pcd").read_text() == (tmp_path / "j.pcd").read_text()


def test_pcd_round_trip(tmp_path):
    pts = np.random.default_rng(0).normal(scale=20.0, size=(50, 3)).astype(np.float32)
    valid = np.arange(50) % 4 != 0
    path = str(tmp_path / "map.pcd")
    assert pointcloud.write_pcd(path, pts, valid) == int(valid.sum())
    back = pointcloud.read_pcd(path)
    np.testing.assert_allclose(back, pts[valid], atol=5e-5)
    np.testing.assert_array_equal(back, JP.read_pcd(path))
