"""Port parity: lidar residual, plane fits, neighbour gathers, voxel grid.

Tolerances:
* rtol 1e-5 for the f32 transforms and residuals (f32 arithmetic with sums
  in another order).
* Plane fits: the validity flags must be identical. The fitted planes are
  f32 solves of A n = −1 whose conditioning degrades as a plane passes
  near the origin; XLA on the CPU contracts the covariance with fused
  multiply-adds and torch does not, which alone moves the normals of such
  planes by up to ~1e-3. So each field is held to the f32 accuracy the
  JAX function itself reaches: against the same JAX function evaluated in
  f64, the port's error may be at most twice JAX's f32 error, plus 1e-6.
* ``gather_neighbors`` and ``voxel_downsample`` must match exactly: the
  same points in the same order, because the map's order and its
  truncation decide which neighbours the association sees.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glio_tpu.factors import lidar as jlidar
from glio_tpu.lidar import neighbors as jnb
from glio_tpu.lidar import plane_fit as jpf
from glio_tpu_torch.factors import lidar as tlidar
from glio_tpu_torch.lidar import neighbors as tnb
from glio_tpu_torch.lidar import plane_fit as tpf

F32 = np.float32
Q_LB = np.array([0.999, 0.01, -0.02, 0.03])
Q_LB /= np.linalg.norm(Q_LB)
T_LB = np.array([0.1, -0.05, 0.28])


def _close(t, j, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def test_body_from_lidar():
    p = np.random.default_rng(0).normal(size=(100, 3)).astype(F32) * 20
    _close(tlidar.body_from_lidar(torch.tensor(p), torch.tensor(Q_LB.astype(F32)),
                                  torch.tensor(T_LB.astype(F32))),
           jlidar.body_from_lidar(jnp.asarray(p), jnp.asarray(Q_LB.astype(F32)),
                                  jnp.asarray(T_LB.astype(F32))))


def test_plane_norm_residual():
    rng = np.random.default_rng(1)
    pts = (rng.normal(size=(100, 3)) * 20).astype(F32)
    nrm = rng.normal(size=(100, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(F32)
    d = rng.normal(size=100).astype(F32)
    score = rng.uniform(0, 7.5, size=100).astype(F32)
    mask = rng.uniform(size=100) > 0.2
    t = np.array([12.0, -3.0, 0.5], F32)
    q = np.array([0.9, 0.1, 0.2, -0.3])
    q = (q / np.linalg.norm(q)).astype(F32)
    args = (pts, nrm, d, score, t, q, Q_LB.astype(F32), T_LB.astype(F32), mask)
    _close(tlidar.plane_norm_residual(*(torch.tensor(a) for a in args)),
           jlidar.plane_norm_residual(*(jnp.asarray(a) for a in args)), atol=1e-4)


def _neighbour_sets(rng, offset, n=1000):
    """Five points 0.7 m apart with 2 cm noise on random planes around
    ``offset``; every seventh set non-planar, some neighbours missing."""
    centre = rng.normal(size=(n, 1, 3)) * 5 + offset
    nrm = rng.normal(size=(n, 1, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    offs = rng.normal(size=(n, 5, 3)) * 0.7
    offs -= (offs * nrm).sum(-1, keepdims=True) * nrm
    noise = np.where(np.arange(n)[:, None, None] % 7 == 0, 0.5, 0.02)
    neigh = (centre + offs + noise * rng.normal(size=(n, 5, 3))).astype(F32)
    valid = rng.uniform(size=(n, 5)) > 0.05
    query = (centre[:, 0] + rng.normal(size=(n, 3)) * 0.3).astype(F32)
    return neigh, valid, query


@pytest.mark.parametrize("offset", [(30.0, -20.0, 1.0), (300.0, -120.0, 2.0)])
@pytest.mark.parametrize("field", ["normal", "d", "weight"])
def test_fit_planes(offset, field):
    neigh, valid, query = _neighbour_sets(np.random.default_rng(2), np.array(offset))
    ft = tpf.fit_planes(torch.tensor(neigh), torch.tensor(valid), torch.tensor(query),
                        plane_tol=0.18)
    fj = jpf.fit_planes(jnp.asarray(neigh), jnp.asarray(valid), jnp.asarray(query),
                        plane_tol=0.18)
    f64 = jpf.fit_planes(jnp.asarray(neigh, jnp.float64), jnp.asarray(valid),
                         jnp.asarray(query, jnp.float64), plane_tol=0.18)
    ok = np.asarray(fj.valid)
    np.testing.assert_array_equal(ft.valid.numpy(), ok)
    assert ok.mean() > 0.8
    ref = np.asarray(getattr(f64, field))[ok]
    err_t = np.abs(getattr(ft, field).numpy()[ok] - ref).max()
    err_j = np.abs(np.asarray(getattr(fj, field))[ok] - ref).max()
    assert err_t <= 2.0 * err_j + 1e-6, (err_t, err_j)


def test_gather_neighbors_exact():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(50, 3)).astype(F32)
    idx = rng.integers(-1, 50, size=(30, 5))
    out_t = tnb.gather_neighbors(torch.tensor(pts), torch.tensor(idx))
    out_j = jnb.gather_neighbors(jnp.asarray(pts), jnp.asarray(idx))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


def _map_ring(rng, n=6000):
    pts = (rng.uniform(-30, 30, size=(n, 3)) + [310.0, -95.0, 0.0]).astype(F32)
    pts[::11] = pts[1::11][: pts[::11].shape[0]]      # duplicate voxels
    return pts, rng.uniform(size=n) > 0.1


@pytest.mark.parametrize("scatter_keys", [False, True])
@pytest.mark.parametrize("max_out", [8192, 700])
def test_voxel_downsample_exact(scatter_keys, max_out):
    pts, valid = _map_ring(np.random.default_rng(4))
    ot, vt = tnb.voxel_downsample(torch.tensor(pts), torch.tensor(valid), 0.4,
                                  max_out, scatter_keys=scatter_keys)
    oj, vj = jnb.voxel_downsample(jnp.asarray(pts), jnp.asarray(valid), 0.4,
                                  max_out, scatter_keys=scatter_keys)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    if max_out == 700:
        assert vt.all()          # the population exceeds max_out: truncated
