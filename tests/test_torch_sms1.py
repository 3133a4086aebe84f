"""Port parity: batch level 1's association (``sms_fusion_level=1``).

Each port function is held against its ``glio_tpu`` counterpart on the
same numpy inputs: ``fit_planes_centroid``, ``binary_plane_residual``,
``gather_neighbors`` and ``knn_pairs`` (its plain version on the CPU)
against ``vmap(neighbors.knn)``; ``build_sms1`` on the JAX package's
level-1 test episode (30 keyframes, 512-point scans, ``search_range=3``);
the pose-only assembly on random correspondences, and its gradient against
``torch.autograd`` through the retraction. The solves and the pipeline
are in ``tests/test_torch_sms1_solve.py``.

Tolerances. The port solves each neighbourhood's 3×3 eigensystem in f64
where JAX uses f32 ``eigh``, and its f32 sums run in another order, so
planarities and normals agree to JAX's f32 error: near-equal planarities
can swap their order in the top-25 selection, and the normal of a
near-collinear neighbourhood (two small eigenvalues close together) is
determined only to ~1e-4. Hence slots are compared by the point they
hold, and the normals to 1e-6 in the median, 1e-4 at the 99th percentile.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glio_tpu.config import EstimatorConfig, GlioConfig
from glio_tpu.data.simulator import simulate_episode as jax_simulate_episode
from glio_tpu.data.simulator import simulate_gnss_epochs as jax_simulate_gnss
from glio_tpu.factors import lidar as jlidar
from glio_tpu.lidar import neighbors as jnb
from glio_tpu.lidar import plane_fit as jpf
from glio_tpu.models import batch as JB
from glio_tpu.utils import quat as jquat
from glio_tpu_torch import convert, testing
from glio_tpu_torch.factors import lidar as tlidar
from glio_tpu_torch.lidar import neighbors as tnb
from glio_tpu_torch.lidar import plane_fit as tpf
from glio_tpu_torch.models import batch as TB
from glio_tpu_torch.ops import knn as tknn
from glio_tpu_torch.utils import profiling

ANCHOR = np.array([-2419233.42, 5385473.13, 2405341.30])
STATION = np.array([-2414266.92, 5386768.987, 2407460.031])
F32 = np.float32
CFG = GlioConfig().replace(estimator=EstimatorConfig(search_range=3, sms_fusion_level=1))
TCFG = convert.config_from_glio(CFG)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _neighbourhoods(rng, Q=400, K=5):
    """Planar, noisy-planar, collinear and isotropic 5-point clouds ~300 m
    out, some with missing neighbours."""
    centre = rng.uniform(-40, 40, size=(Q, 1, 3)) + [300.0, -80.0, 2.0]
    kind = np.arange(Q) % 4
    local = rng.normal(size=(Q, K, 3))
    local[kind == 0, :, 2] = 0.0                                  # exact planes
    local[kind == 1, :, 2] *= 0.01                                # noisy planes
    local[kind == 2, :, 1:] *= 0.02                               # near lines
    neigh = (centre + local).astype(F32)
    valid = rng.uniform(size=(Q, K)) > 0.1
    valid[::7, 2:] = False                                        # fewer than 3
    neigh = np.where(valid[..., None], neigh, 0.0).astype(F32)
    return neigh, valid


def test_fit_planes_centroid_matches_jax():
    neigh, valid = _neighbourhoods(np.random.default_rng(0))
    nj, cj, pj, vj = (np.asarray(a) for a in jpf.fit_planes_centroid(
        jnp.asarray(neigh), jnp.asarray(valid), min_planarity=0.8))
    nt, ct, pt, vt = (a.numpy() for a in tpf.fit_planes_centroid(
        _t(neigh), _t(valid), min_planarity=0.8))
    np.testing.assert_allclose(ct, cj, rtol=5e-7)                 # f32 sums of 5: 2 ulp
    np.testing.assert_allclose(pt, pj, rtol=0, atol=2e-6)         # f32 eigenvalues
    far = np.abs(pj - 0.8) > 1e-5                                 # not at the gate
    np.testing.assert_array_equal(vt[far], vj[far])
    assert vj.sum() > 100
    # Normals up to sign where the smallest eigenvalue is well separated.
    sep = vj & (np.arange(len(vj)) % 4 < 2)
    sign = np.sign(np.sum(nt * nj, -1, keepdims=True))
    assert np.abs(nt - sign * nj)[sep].max() < 1e-5
    np.testing.assert_allclose(np.linalg.norm(nt, axis=-1), 1.0, atol=1e-6)


def test_binary_plane_residual_matches_jax():
    rng = np.random.default_rng(1)
    N = 50
    args = [rng.normal(size=(N, 3)), rng.normal(size=(N, 3)), rng.normal(size=(N, 3)),
            rng.uniform(1, 7.5, N)]
    q1, q2 = (q / np.linalg.norm(q) for q in rng.normal(size=(2, 4)))
    t1, t2 = rng.normal(size=(2, 3)) * 10
    mask = rng.uniform(size=N) > 0.3
    want = np.asarray(jlidar.binary_plane_residual(
        *(jnp.asarray(a) for a in args), jnp.asarray(t1), jnp.asarray(q1), jnp.asarray(t2),
        jnp.asarray(q2), jnp.asarray(mask)))
    got = tlidar.binary_plane_residual(*(_t(a) for a in args), _t(t1), _t(q1), _t(t2),
                                       _t(q2), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)
    assert np.all(got[~mask] == 0.0)


def _stack(rng, F=6, S=300):
    world = (rng.uniform(-20, 20, size=(F, S, 3)) + [300.0, -80.0, 2.0]).astype(F32)
    valid = rng.uniform(size=(F, S)) > 0.1
    valid[3] = False                                              # an all-invalid frame
    return world, valid


def test_knn_pairs_matches_jax_vmap():
    """Indices compared as sets per query (JAX breaks ties arbitrarily),
    distances to rtol 1e-5 (XLA may contract the squares with FMAs)."""
    world, valid = _stack(np.random.default_rng(2))
    ii = np.array([0, 1, 2, 3, 4, 5, 0, 2], np.int64)
    jj = np.array([1, 2, 3, 4, 5, 0, 3, 2], np.int64)
    w, v = jnp.asarray(world), jnp.asarray(valid)
    d_j, i_j = jax.vmap(lambda i, j: jnb.knn(w[i], v[i], w[j], v[j], k=5))(
        jnp.asarray(ii), jnp.asarray(jj))
    d_t, i_t = tknn.knn_pairs(_t(world), _t(valid), _t(ii), _t(jj))
    d_j, i_j = np.asarray(d_j), np.asarray(i_j)
    assert d_t.shape == (8, 300, 5) and i_t.dtype == torch.int64
    fin = np.isfinite(d_j)
    np.testing.assert_array_equal(np.isfinite(d_t.numpy()), fin)
    np.testing.assert_allclose(d_t.numpy()[fin], d_j[fin], rtol=1e-5)
    np.testing.assert_array_equal(np.sort(i_t.numpy(), -1), np.sort(i_j, -1))
    assert (i_t[2:4] == -1).all() and (i_t[6] == -1).all()        # maps of frame 3


def test_knn_pairs_is_the_plain_version_of_each_pair():
    world, valid = _stack(np.random.default_rng(3), S=77)
    ii, jj = np.array([5, 0, 4], np.int64), np.array([0, 5, 4], np.int64)
    before = profiling.tallies().get("knn_pairs.launches", 0)
    d, i = tknn.knn_pairs(_t(world), _t(valid), _t(ii), _t(jj))
    assert profiling.tallies().get("knn_pairs.launches", 0) == before   # no kernel on the CPU
    for b in range(3):
        d_r, i_r = tknn.knn_reference(_t(world[ii[b]]), _t(valid[ii[b]]),
                                      _t(world[jj[b]]), _t(valid[jj[b]]))
        assert torch.equal(d[b], d_r) and torch.equal(i[b], i_r)
    d0, i0 = tknn.knn_pairs(_t(world), _t(valid), _t(ii[:0]), _t(jj[:0]))
    assert d0.shape == (0, 77, 5) and i0.shape == (0, 77, 5)


@pytest.mark.parametrize("bad", ["world_f64", "valid_shape", "idx_int32", "idx_length",
                                 "world_2d"])
def test_knn_pairs_rejects_bad_input(bad):
    world, valid = _stack(np.random.default_rng(4), S=20)
    args = [_t(world), _t(valid), torch.tensor([0, 1]), torch.tensor([1, 2])]
    if bad == "world_f64":
        args[0] = args[0].double()
    elif bad == "valid_shape":
        args[1] = args[1][:, :10]
    elif bad == "idx_int32":
        args[2] = args[2].int()
    elif bad == "idx_length":
        args[3] = torch.tensor([1])
    else:
        args[0] = args[0][0]
    with pytest.raises((TypeError, ValueError)):
        tknn.knn_pairs(*args)


@pytest.mark.parametrize("n_pairs", [65535, 65536])
def test_knn_pairs_takes_at_most_65535_pairs(n_pairs):
    """A batch takes the grid's y dimension: 65,535 pairs run in one call,
    each equal to its pair's ``knn_reference``; one more is refused before
    anything runs, on every device."""
    world, valid = _stack(np.random.default_rng(6), F=4, S=8)
    rng = np.random.default_rng(7)
    ii, jj = rng.integers(0, 4, n_pairs), rng.integers(0, 4, n_pairs)
    args = (_t(world), _t(valid), _t(ii), _t(jj))
    if n_pairs > tknn.MAX_PAIRS:
        with pytest.raises(ValueError, match="at most 65535"):
            tknn.knn_pairs(*args)
        return
    d, i = tknn.knn_pairs(*args)
    assert d.shape == i.shape == (n_pairs, 8, 5)
    for b in (0, 1, n_pairs - 1):
        d_r, i_r = tknn.knn_reference(_t(world[ii[b]]), _t(valid[ii[b]]),
                                      _t(world[jj[b]]), _t(valid[jj[b]]))
        assert torch.equal(d[b], d_r) and torch.equal(i[b], i_r)


@pytest.mark.parametrize("batch", [1, 2, 256, 20937])
def test_knn_plan_counts_the_batch(batch):
    """A real batch fills the card with clusters of one block; one pair
    alone still splits its map."""
    per_tile, cluster, split = tknn.knn_plan(1024, 1024, 132, batch=batch)
    assert per_tile == 16
    assert cluster == (4 if batch == 1 else 2 if batch == 2 else 1)
    assert cluster * split >= 1024 and tknn.knn_plan(1024, 1024, 132) == \
        tknn.knn_plan(1024, 1024, 132, batch=1)


def test_gather_neighbors_batched_matches_jax():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(4, 30, 3)).astype(F32)
    idx = rng.integers(-1, 30, size=(4, 10, 5))
    want = np.stack([np.asarray(jnb.gather_neighbors(jnp.asarray(pts[b]), jnp.asarray(idx[b])))
                     for b in range(4)])
    got = tnb.gather_neighbors(_t(pts), _t(idx)).numpy()
    np.testing.assert_array_equal(got, want)


# --- the association ---------------------------------------------------------------

def _assoc_episode():
    return dict(n_keyframes=30, scan_points=512, seed=6, scan_noise=0.01,
                q_lb=(1, 0, 0, 0), t_lb=(0, 0, 0))


@pytest.fixture(scope="module")
def association():
    ep = jax_simulate_episode(**_assoc_episode())
    sj = JB.build_sms1(CFG, ep.scan, ep.scan_valid, ep.gt_p, ep.gt_q, chunk=32)
    st = TB.build_sms1(TCFG, ep.scan, ep.scan_valid, ep.gt_p, ep.gt_q, device="cpu")
    return ep, jax.tree.map(np.asarray, sj), st


def _by_point(sms):
    """Each (t, r)'s slots ordered by the point they hold."""
    pts, nrm, cen, score = (np.asarray(a) for a in sms[:4])
    T, R, F, _ = pts.shape
    out = [np.empty_like(a) for a in (pts, nrm, cen, score)]
    for t in range(T):
        for r in range(R):
            o = np.lexsort(pts[t, r].T[::-1])
            for a, b in zip(out, (pts, nrm, cen, score)):
                a[t, r] = b[t, r][o]
    return out


def test_build_sms1_matches_jax(association):
    _, sj, st = association
    mask = np.asarray(sj.mask)
    np.testing.assert_array_equal(st.mask.numpy(), mask)
    assert mask.sum() > 1000 and not mask[-1].any() and not mask[-3:, 2].any()
    (pj, nj, cj, sj_), (pt, nt, ct, st_) = _by_point(sj), _by_point(st)
    same = np.all(pj == pt, axis=-1)                          # the slot holds the same point
    pair_same = np.all(same | ~mask, axis=-1)
    assert pair_same.mean() >= 0.9, pair_same.mean()          # near-ties swap a few
    ok = same & mask
    np.testing.assert_allclose(ct[ok], cj[ok], rtol=0, atol=1e-4)   # a few f32 ulps at 300 m
    np.testing.assert_allclose(st_[ok], sj_[ok], rtol=0, atol=1e-5)
    sign = np.sign(np.sum(nt * nj, -1, keepdims=True))
    err = np.abs(nt - sign * nj).max(-1)[ok]
    assert np.median(err) < 1e-6 and np.quantile(err, 0.99) < 1e-4 and err.max() < 1e-3, \
        (np.median(err), np.quantile(err, 0.99), err.max())


def test_build_sms1_does_not_depend_on_the_chunk(association):
    ep, _, st = association
    st7 = TB.build_sms1(TCFG, ep.scan, ep.scan_valid, ep.gt_p, ep.gt_q, chunk=7,
                        device="cpu")
    for a, b in zip(st, st7):
        assert torch.equal(a, b)


def test_selected_indices_names_each_slots_point(association):
    """The index of each slot's point in its frame's scan: the scan's point
    there is the slot's, and empty slots read 0xFFFF."""
    ep, _, st = association
    mask = st.mask.numpy()
    sel = testing.selected_indices(ep.scan, st.pts_i.numpy(), mask)
    assert sel.dtype == np.uint16 and (sel[~mask] == 0xFFFF).all()
    frame = np.arange(mask.shape[0])[:, None, None]
    pts = np.asarray(ep.scan, np.float32)[frame, np.where(mask, sel, 0)].astype(np.float64)
    np.testing.assert_array_equal(pts[mask], st.pts_i.numpy()[mask])


def test_selected_indices_refuses_a_point_not_in_its_scan(association):
    ep, sj, _ = association
    pts = np.array(sj.pts_i)
    pts[0, 0, 0] += 1.0
    with pytest.raises(ValueError, match="frame 0"):
        testing.selected_indices(ep.scan, pts, np.asarray(sj.mask))


def test_build_sms1_reports_its_stage_times(association):
    ep, _, st = association
    timings = {}
    out = TB.build_sms1(TCFG, ep.scan[:8], ep.scan_valid[:8], ep.gt_p[:8], ep.gt_q[:8],
                        device="cpu", timings=timings)
    assert set(timings) == {"knn", "planes", "select"} and all(v >= 0 for v in timings.values())
    assert torch.equal(out.mask[:4, 0], st.mask[:4, 0])


# --- the pose-only assembly --------------------------------------------------------

@pytest.fixture(scope="module")
def random_sms():
    """tests/test_batch.py's random correspondences over a short drive."""
    rng = np.random.default_rng(9)
    T, R, F = 12, 2, 6
    cfg = GlioConfig().replace(estimator=EstimatorConfig(search_range=R))
    kf_time = np.arange(T) / 3.0
    th = np.linspace(0, 1, T)
    p_true = np.stack([10 * th, 3 * np.sin(th), 0.2 * th], -1)
    ypr = np.stack([0.3 * np.sin(th), 0.1 * th, 0.05 * np.cos(th)], -1)
    q_true = np.asarray(jquat.from_ypr(jnp.asarray(ypr)))
    gnss = jax_simulate_gnss(p_true, kf_time, ANCHOR, STATION, psr_noise=0.3, seed=9)
    prob = JB.build_problem(cfg, p_true, q_true, kf_time, gnss, ANCHOR, 0.0, STATION)
    nrm = rng.normal(size=(T, R, F, 3))
    sms = JB.Sms1Data(
        pts_i=jnp.asarray(rng.normal(size=(T, R, F, 3))),
        normal_j=jnp.asarray(nrm / np.linalg.norm(rng.normal(size=(T, R, F, 3)), axis=-1,
                                                  keepdims=True)),
        cent_j=jnp.asarray(rng.normal(size=(T, R, F, 3))),
        score=jnp.asarray(rng.uniform(1.0, 7.5, (T, R, F))),
        mask=jnp.asarray((rng.uniform(size=(T, R, F)) > 0.3)
                         & (np.arange(T)[:, None, None]
                            + np.arange(1, R + 1)[None, :, None] < T)))
    prob_t = convert.batch_problem_from_numpy(jax.tree.map(np.asarray, prob), "cpu")
    sms_t = TB.Sms1Data(*(torch.as_tensor(np.asarray(a)) for a in sms))
    return cfg, prob, sms, prob_t, sms_t, p_true, q_true


def test_assemble_sms1_pose_matches_jax(random_sms):
    cfg, prob, sms, prob_t, sms_t, p, q = random_sms
    hw = cfg.estimator.search_range + 1
    band_j, grad_j = (np.asarray(a) for a in JB._assemble_sms1_pose(
        jnp.asarray(p), jnp.asarray(q), prob, sms, jnp.asarray(5.0), hw))
    band_t, grad_t = TB._assemble_sms1_pose(_t(p), _t(q), prob_t, sms_t, 5.0, hw)
    assert band_t.shape == band_j.shape
    np.testing.assert_allclose(band_t.numpy(), band_j, rtol=0,
                               atol=1e-12 * np.abs(band_j).max())
    np.testing.assert_allclose(grad_t.numpy(), grad_j, rtol=0,
                               atol=1e-12 * np.abs(grad_j).max())
    cost_j = float(0.5 * (jnp.sum(JB._rel_residuals(jnp.asarray(p), jnp.asarray(q), prob)
                                  [..., :3] ** 2)
                          + jnp.sum(JB._sms1_residuals(jnp.asarray(p), jnp.asarray(q),
                                                       sms) ** 2)
                          + jnp.sum(JB._dd_residuals(jnp.asarray(p), prob,
                                                     jnp.asarray(5.0)) ** 2)))
    np.testing.assert_allclose(float(TB._sms1_cost(_t(p), _t(q), prob_t, sms_t, 5.0)),
                               cost_j, rtol=1e-13)


def test_assemble_sms1_pose_gradient_matches_autograd(random_sms):
    """The analytic Jacobians against torch.autograd of the level-1 cost
    through the retraction (round-off: weights reach W_ATT² = 1e8)."""
    cfg, _, _, prob_t, sms_t, p, q = random_sms
    hw = cfg.estimator.search_range + 1
    _, grad = TB._assemble_sms1_pose(_t(p), _t(q), prob_t, sms_t, 5.0, hw)
    dx = torch.zeros(p.shape[0] * 6, dtype=torch.float64, requires_grad=True)
    pp, qq = TB._retract(_t(p), _t(q), dx)
    TB._sms1_cost(pp, qq, prob_t, sms_t, 5.0).backward()
    g_ad = dx.grad.numpy()
    rel = np.abs(grad.numpy().reshape(-1) - g_ad).max() / np.abs(g_ad).max()
    assert rel < 1e-7, rel
