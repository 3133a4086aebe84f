"""Port parity: the small public functions of ``glio_tpu`` off the pipeline's paths.

The LiDAR rows, the IMU residual whitened at every call, the Gauss-Newton and
dogleg solvers, the marginal prior's helpers, SO(3), the quaternion and
coordinate helpers, the KML and skyplot writers, the npz checkpoint pair and
the profiler. The same numpy inputs (the JAX tests' cases, and the
simulator's where the JAX package has no test) go through both packages.

Tolerance 1e-12 where both sides run the same f64 formulas; 1e-9 on the
whitened IMU residual (its whitening reaches 1e3, as in
``tests/test_torch_imu.py``) and on the solvers' iterates (the same
iterations with forward-mode Jacobians of each framework). The KML and SVG
files are byte-equal.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glio_tpu.data.simulator import simulate_episode as j_simulate_episode
from glio_tpu.eval import skyplot as jsky
from glio_tpu.eval import trajectory as jtraj
from glio_tpu.factors import imu as jimu
from glio_tpu.factors import lidar as jlidar
from glio_tpu.solver import dense as jdense
from glio_tpu.solver import marginalization as jmarg
from glio_tpu.utils import checkpoint as jckpt
from glio_tpu.utils import coords as jcoords
from glio_tpu.utils import quat as jquat
from glio_tpu.utils import so3 as jso3
from glio_tpu_torch import testing
from glio_tpu_torch.config import GlioConfig
from glio_tpu_torch.eval import skyplot as tsky
from glio_tpu_torch.eval import trajectory as ttraj
from glio_tpu_torch.factors import imu as timu
from glio_tpu_torch.factors import lidar as tlidar
from glio_tpu_torch.gnss import converter as tconv
from glio_tpu_torch.models.sliding_window import SlidingWindowEstimator
from glio_tpu_torch.solver import dense as tdense
from glio_tpu_torch.solver import marginalization as tmarg
from glio_tpu_torch.utils import checkpoint as tckpt
from glio_tpu_torch.utils import coords as tcoords
from glio_tpu_torch.utils import profiling as tprof
from glio_tpu_torch.utils import quat as tquat
from glio_tpu_torch.utils import so3 as tso3

TOL = 1e-12


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _both(*arrays):
    return [torch.tensor(a) for a in arrays], [jnp.asarray(a) for a in arrays]


@pytest.fixture(scope="module")
def episode():
    """A short simulated drive: scans, poses and IMU runs."""
    return j_simulate_episode(n_keyframes=4, scan_points=128, seed=2)


# --- factors/lidar.py ---------------------------------------------------------------

def test_plane_incre_residual(episode):
    rng = np.random.default_rng(0)
    p_l = episode.scan[1].astype(np.float64)
    n = rng.normal(size=p_l.shape)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = rng.normal(size=len(p_l)) * 3.0
    mask = episode.scan_valid[1] & (rng.random(len(p_l)) > 0.2)
    args = (p_l, n, d, episode.gt_p[1], episode.gt_q[1], mask)
    t, j = _both(*args)
    _close(tlidar.plane_incre_residual(*t), jlidar.plane_incre_residual(*j))


def test_edge_residual():
    ident, z3 = np.array([1.0, 0, 0, 0]), np.zeros(3)
    t, j = _both(np.array([[0.5, 2.0, 0.0]]), np.zeros((1, 3)), np.array([[1.0, 0, 0]]),
                 np.ones(1), z3, ident, ident, z3, np.array([True]))
    _close(tlidar.edge_residual(*t), jlidar.edge_residual(*j))
    np.testing.assert_allclose(tlidar.edge_residual(*t).numpy(), 2.0, atol=1e-6)
    rng = np.random.default_rng(1)
    N = 64
    t, j = _both(rng.normal(size=(N, 3)) * 20, rng.normal(size=(N, 3)) * 20,
                 rng.normal(size=(N, 3)) * 20, rng.random(N), rng.normal(size=3),
                 _quats(rng, 1)[0], _quats(rng, 1)[0], rng.normal(size=3) * 0.1,
                 rng.random(N) > 0.3)
    _close(tlidar.edge_residual(*t), jlidar.edge_residual(*j))


def test_relative_attitude_residual():
    rng = np.random.default_rng(2)
    qi, qj = _quats(rng, 16), _quats(rng, 16)
    dq = jquat.mul(jquat.conj(jnp.asarray(qi)), jnp.asarray(qj))
    dq_noisy = np.asarray(dq) + rng.normal(size=dq.shape) * 1e-3
    for delta in (np.asarray(dq), dq_noisy):
        t, j = _both(qi, qj, delta, np.full(16, 10000.0), rng.random(16) > 0.25)
        _close(tlidar.relative_attitude_residual(*t), jlidar.relative_attitude_residual(*j),
               tol=1e-8)    # weight 1e4 times f64 round-off of unit quaternions
    np.testing.assert_allclose(
        tlidar.relative_attitude_residual(*_both(qi, qj, np.asarray(dq), np.full(16, 1e4),
                                                 np.ones(16, bool))[0]).numpy(), 0.0, atol=1e-8)


def test_roll_pitch_residual(episode):
    rng = np.random.default_rng(3)
    up = rng.normal(size=(4, 3)) * 0.05 + [0, 0, 1]
    up /= np.linalg.norm(up, axis=-1, keepdims=True)
    t, j = _both(episode.gt_q, up)
    _close(tlidar.roll_pitch_residual(*t), jlidar.roll_pitch_residual(*j))
    _close(tlidar.roll_pitch_residual(*t, weight=3.0), jlidar.roll_pitch_residual(*j, weight=3.0))


# --- factors/imu.py -------------------------------------------------------------------

def test_whitened_residual(episode):
    assert timu.NOISE_DIM == jimu.NOISE_DIM == 18
    ep = episode
    gravity = jimu.ImuParams().gravity_vec()
    for e in (1, 2):
        args = (ep.imu_acc[e], ep.imu_gyr[e], ep.imu_dt[e], ep.imu_valid[e], np.zeros(3),
                np.zeros(3), ep.imu_acc[e - 1, -1], ep.imu_gyr[e - 1, -1])
        t, j = _both(*args)
        pt = timu.preintegrate(*t, timu.ImuParams().noise_cov())
        pj = jimu.preintegrate(*j, cov_dtype=jnp.float64)
        ba = np.full(3, 0.01)
        state = [ep.gt_p[e - 1], ep.gt_q[e - 1], ep.gt_v[e - 1], ba, ba * 0.1,
                 ep.gt_p[e] + 0.01, ep.gt_q[e], ep.gt_v[e], ba, ba * 0.1]
        ts, js = _both(*state)
        rt = timu.whitened_residual(pt, *ts, gravity=torch.tensor(np.asarray(gravity)))
        rj = jimu.whitened_residual(pj, *js, gravity=gravity)
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-9, atol=1e-9)
        # The same as the cached form.
        _close(rt, timu.whitened_residual_cached(timu.sqrt_info(pt), pt, *ts,
                                                 gravity=torch.tensor(np.asarray(gravity))))


# --- solver/dense.py ------------------------------------------------------------------

def _rosenbrock(xp):
    def residual(x):
        return xp.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])
    return residual, (lambda x, d: x + d), np.array([-1.2, 1.0])


def _pose_chain(episode):
    """Three keyframes of the drive: a prior on the first and relative-pose
    rows from the truth, solved from a perturbed start (tangent [δp | δθ])."""
    p_true, q_true = episode.gt_p[:3], episode.gt_q[:3]
    rng = np.random.default_rng(4)
    p0 = p_true + rng.normal(size=p_true.shape) * 0.3
    q0 = np.asarray(jquat.normalize(jnp.asarray(q_true + rng.normal(size=q_true.shape) * 0.05)))

    def make(qm, xp, stack, cat):
        dp = qm.rotate(qm.conj(xp(q_true[:-1])), xp(p_true[1:] - p_true[:-1]))
        dq = qm.mul(qm.conj(xp(q_true[:-1])), xp(q_true[1:]))

        def residual(x):
            p, q = x[:9].reshape(3, 3), x[9:].reshape(3, 4)
            r_prior = cat([p[0] - xp(p_true[0]), qm.log(qm.mul(qm.conj(xp(q_true[0])), q[0]))])
            rel_p = qm.rotate(qm.conj(q[:-1]), p[1:] - p[:-1]) - dp
            rel_q = qm.mul(qm.conj(dq), qm.mul(qm.conj(q[:-1]), q[1:]))[:, 1:]
            return cat([r_prior, rel_p.reshape(-1), 2.0 * rel_q.reshape(-1)])

        def retract(x, d):
            d = d.reshape(3, 6)
            p = x[:9].reshape(3, 3) + d[:, :3]
            q = qm.normalize(qm.mul(x[9:].reshape(3, 4), qm.exp(d[:, 3:])))
            return cat([p.reshape(-1), q.reshape(-1)])
        return residual, retract

    x0 = np.concatenate([p0.reshape(-1), q0.reshape(-1)])
    return (make(tquat, torch.tensor, torch.stack, torch.cat),
            make(jquat, jnp.asarray, jnp.stack, jnp.concatenate), x0)


def _solver_cases(episode):
    rt, rx0 = _rosenbrock(torch)[:2], _rosenbrock(jnp)
    (pt, pj, px0) = _pose_chain(episode)
    return {"rosenbrock": (rt, rx0[:2], rx0[2], 2), "pose_chain": (pt, pj, px0, 18)}


@pytest.mark.parametrize("case", ["rosenbrock", "pose_chain"])
@pytest.mark.parametrize("solver,kw", [("gn_solve", dict(max_iters=8)),
                                       ("dogleg_solve", dict(max_iters=60))])
def test_dense_solvers(episode, case, solver, kw):
    (res_t, ret_t), (res_j, ret_j), x0, n = _solver_cases(episode)[case]
    if case == "rosenbrock" and solver == "gn_solve":
        kw = dict(max_iters=60)
    out_t = getattr(tdense, solver)(res_t, ret_t, torch.tensor(x0), n, **kw)
    out_j = getattr(jdense, solver)(res_j, ret_j, jnp.asarray(x0), n, **kw)
    np.testing.assert_allclose(out_t.x.numpy(), np.asarray(out_j.x), rtol=1e-9, atol=1e-9)
    for f in ("cost", "initial_cost", "lam"):
        np.testing.assert_allclose(float(getattr(out_t, f)), float(getattr(out_j, f)),
                                   rtol=1e-9, atol=1e-12)
    assert int(out_t.iters) == int(out_j.iters)
    if case == "rosenbrock":
        np.testing.assert_allclose(out_t.x.numpy(), [1.0, 1.0], atol=1e-6)
    else:
        assert float(out_t.cost) < 1e-12


# --- solver/marginalization.py ------------------------------------------------------------

def test_identity_prior_and_prior_residual():
    pt, pj = tmarg.identity_prior(6), jmarg.identity_prior(6)
    assert not bool(pt.valid)
    _close(tmarg.prior_residual(pt, torch.ones(6, dtype=torch.float64)),
           jmarg.prior_residual(pj, jnp.ones(6)))
    rng = np.random.default_rng(5)
    J = rng.normal(size=(30, 12))
    H, b = J.T @ J, J.T @ rng.normal(size=30)
    pt = tmarg.marginalize(torch.tensor(H), torch.tensor(b), 6)
    pj = jmarg.marginalize(jnp.asarray(H), jnp.asarray(b), 6, mixed_chol=False)
    dx = rng.normal(size=6)
    assert bool(pt.valid) and bool(pj.valid)
    _close(tmarg.prior_residual(pt, torch.tensor(dx)), jmarg.prior_residual(pj, jnp.asarray(dx)),
           tol=1e-10)


# --- utils/so3.py, utils/quat.py, utils/coords.py -----------------------------------------

def _vecs(rng, n, scale=1.0):
    th = rng.normal(size=(n, 3))
    th /= np.linalg.norm(th, axis=-1, keepdims=True)
    return th * rng.uniform(0.0, 3.1, size=(n, 1)) * scale


def test_so3_vee_exp():
    rng = np.random.default_rng(6)
    th = _vecs(rng, 32)
    th[0] = 0.0
    th[1] = [1e-9, 0.0, -1e-9]
    _close(tso3.exp(torch.tensor(th)), jso3.exp(jnp.asarray(th)))
    m = rng.normal(size=(8, 3, 3))
    _close(tso3.vee(torch.tensor(m)), jso3.vee(jnp.asarray(m)))


@pytest.mark.parametrize("where", ["random", "near_zero", "near_pi"])
def test_so3_log(where):
    rng = np.random.default_rng(7)
    if where == "random":
        th = _vecs(rng, 32)
    elif where == "near_zero":
        th = _vecs(rng, 16, scale=1e-7)
        th[0] = 0.0
    else:
        th = _vecs(rng, 16)
        th *= (np.pi - 1e-7) / np.linalg.norm(th, axis=-1, keepdims=True)
        th[:3] = np.eye(3) * (np.pi - 1e-7)
    R = np.asarray(jso3.exp(jnp.asarray(th)))
    # Near π the angle is ill-conditioned in R: 1e-7 relative of round-off.
    tol = 1e-6 if where == "near_pi" else TOL
    _close(tso3.log(torch.tensor(R)), jso3.log(jnp.asarray(R)), tol=tol)
    np.testing.assert_allclose(tso3.log(torch.tensor(R)).numpy(), th, atol=1e-6)


@pytest.mark.parametrize("name", ["left_jacobian", "right_jacobian", "inv_right_jacobian"])
def test_so3_jacobians(name):
    rng = np.random.default_rng(8)
    th = _vecs(rng, 32, scale=0.5)
    th[0] = 0.0
    th[1] = [1e-8, -2e-8, 0.0]                     # the Taylor branch
    _close(getattr(tso3, name)(torch.tensor(th)), getattr(jso3, name)(jnp.asarray(th)))


def test_from_rotmat_every_branch():
    rng = np.random.default_rng(9)
    q = _quats(rng, 40)
    # Each largest diagonal combination: near identity (trace), and rotations
    # near π about x, y and z.
    q[:4] = [[1.0, 0.01, -0.02, 0.03], [0.01, 1.0, 0.02, -0.01],
             [0.02, -0.01, 1.0, 0.01], [-0.01, 0.02, 0.01, 1.0]]
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    R = np.asarray(jquat.to_rotmat(jnp.asarray(q)))
    scores = np.stack([1 + np.trace(R, axis1=-2, axis2=-1),
                       1 + R[:, 0, 0] - R[:, 1, 1] - R[:, 2, 2],
                       1 - R[:, 0, 0] + R[:, 1, 1] - R[:, 2, 2],
                       1 - R[:, 0, 0] - R[:, 1, 1] + R[:, 2, 2]], -1)
    assert set(np.argmax(scores[:4], -1)) == {0, 1, 2, 3}
    qt = tquat.from_rotmat(torch.tensor(R))
    _close(qt, jquat.from_rotmat(jnp.asarray(R)))
    np.testing.assert_allclose(qt.numpy(), np.asarray(jquat.positive_hemisphere(jnp.asarray(q))),
                               atol=1e-9)


def test_g2q():
    rng = np.random.default_rng(10)
    g = rng.normal(size=(8, 3)) * 0.5 + [0.0, 0.0, 9.7]
    g[0] = [0.3, -0.2, 9.7]                        # the JAX test's
    qt = tquat.g2q(torch.tensor(g))
    _close(qt, jquat.g2q(jnp.asarray(g)), tol=1e-10)
    aligned = tquat.rotate(qt, torch.tensor(g / np.linalg.norm(g, axis=-1, keepdims=True)))
    np.testing.assert_allclose(aligned.numpy(), np.tile([0, 0, 1.0], (8, 1)), atol=1e-8)


def test_gpst2unix_and_sat_azel():
    week, tow = 2158, 455342.26653504
    assert tcoords.gpst2unix(week, tow) == float(jcoords.gpst2unix(week, tow))
    np.testing.assert_allclose(tcoords.gpst2unix(week, tow), 1621578524.26653504, atol=1e-6)
    w = np.array([2158.0, 2200.0])
    _close(tcoords.gpst2unix(torch.tensor(w), torch.tensor([1.5, 3e5])),
           jcoords.gpst2unix(jnp.asarray(w), jnp.asarray([1.5, 3e5])))
    rng = np.random.default_rng(11)
    rcv = np.asarray(GlioConfig().initialization.station_ecef)
    sat = rng.normal(size=(2, 12, 3)) * 1.5e7 + rcv * 4.0
    sat[0, 0] = rcv + rcv / np.linalg.norm(rcv) * 2e7       # at the zenith
    for t, j in zip(tcoords.sat_azel(torch.tensor(rcv), torch.tensor(sat)),
                    jcoords.sat_azel(jnp.asarray(rcv), jnp.asarray(sat))):
        _close(t, j, tol=1e-11)
    assert abs(float(tcoords.sat_azel(torch.tensor(rcv), torch.tensor(sat))[1][0, 0])
               - np.pi / 2) < 1e-2


# --- eval: the KML and skyplot writers -------------------------------------------------------

def test_write_kml_byte_equal(tmp_path):
    llh = np.array([[0.39, 1.99, 5.0], [0.391, 1.991, 6.0], [0.3912345678, 1.9912345678, -3.25]])
    ttraj.write_kml(str(tmp_path / "t.kml"), llh, name="drive")
    jtraj.write_kml(str(tmp_path / "j.kml"), llh, name="drive")
    assert (tmp_path / "t.kml").read_bytes() == (tmp_path / "j.kml").read_bytes()
    assert b"114" in (tmp_path / "t.kml").read_bytes()


@pytest.fixture(scope="module")
def synthetic_gnss(tmp_path_factory):
    d = tmp_path_factory.mktemp("sky")
    sc = dict(testing.GNSS_DRIVE, n_keyframes=90)
    _, _, _, _, t_gps, rover = testing.gnss_drive(sc)
    obs, nav = str(d / "drive.obs"), str(d / "drive.nav")
    testing.write_synthetic_rinex(obs, nav, t_gps, rover, seed=sc["seed"], n_gps=sc["n_gps"],
                                  n_bds=sc["n_bds"])
    return tconv.convert(obs, nav, GlioConfig().initialization.station_ecef)


@pytest.mark.parametrize("azimuth", [False, True])
def test_write_skyplot_svg_byte_equal(tmp_path, synthetic_gnss, azimuth):
    g = synthetic_gnss
    if azimuth:       # a caller's epochs with an azimuth field
        az = np.random.default_rng(12).uniform(-np.pi, np.pi, g.valid.shape)
        g = types.SimpleNamespace(**vars(g), azimuth=az)
    for kw in (dict(), dict(max_tracks=5, title="drive", elevation_mask_deg=10.0)):
        rt = tsky.write_skyplot_svg(str(tmp_path / "t.svg"), g, **kw)
        rj = jsky.write_skyplot_svg(str(tmp_path / "j.svg"), g, **kw)
        assert rt == rj and rt["n_sats"] > 0
        assert (tmp_path / "t.svg").read_bytes() == (tmp_path / "j.svg").read_bytes()
    assert tsky.SYS_NAMES == jsky.SYS_NAMES and tsky.SYS_COLORS == jsky.SYS_COLORS


# --- utils/checkpoint.py, utils/profiling.py -------------------------------------------------

def test_checkpoint_roundtrip_and_jax_layout(tmp_path):
    tree = {"b": (torch.ones(4, dtype=torch.float32), torch.tensor(3, dtype=torch.int32)),
            "a": torch.arange(6, dtype=torch.float64).reshape(2, 3), "c": None}
    like = {"a": torch.zeros((2, 3), dtype=torch.float64), "c": None,
            "b": (torch.zeros(4, dtype=torch.float32), torch.tensor(0, dtype=torch.int32))}
    path = str(tmp_path / "t.npz")
    tckpt.save_pytree(path, tree)
    out = tckpt.load_pytree(path, like)
    assert torch.equal(out["a"], tree["a"]) and torch.equal(out["b"][0], tree["b"][0])
    assert int(out["b"][1]) == 3 and out["b"][1].dtype == torch.int32 and out["c"] is None
    # The port's archive is the JAX package's: JAX loads it, and the port loads JAX's.
    jlike = {"a": jnp.zeros((2, 3)), "c": None,
             "b": (jnp.zeros(4, jnp.float32), jnp.asarray(0, jnp.int32))}
    jout = jckpt.load_pytree(path, jlike)
    np.testing.assert_array_equal(np.asarray(jout["a"]), tree["a"].numpy())
    jckpt.save_pytree(str(tmp_path / "j.npz"), jout)
    back = tckpt.load_pytree(str(tmp_path / "j.npz"), like)
    assert all(torch.equal(x, y) for x, y in zip(tckpt._leaves(back), tckpt._leaves(tree)))


def test_checkpoint_of_the_window_carry(tmp_path):
    cfg = GlioConfig().replace(shapes=GlioConfig().shapes.__class__(
        max_imu_per_interval=8, scan_points=16, map_points=64))
    est = SlidingWindowEstimator(cfg, "cpu")
    carry = est.make_initial_carry([1.0, 2.0, 3.0], [1.0, 0, 0, 0], [0.5, 0, 0], n_imu=8)
    carry = carry._replace(base=carry.base._replace(
        kf_count=torch.tensor(7, dtype=torch.int32),
        map_world=torch.rand(carry.base.map_world.shape, generator=torch.Generator().manual_seed(0))))
    path = str(tmp_path / "carry.npz")
    tckpt.save_pytree(path, carry)
    out = tckpt.load_pytree(path, carry)
    assert type(out) is type(carry) and type(out.base) is type(carry.base)
    assert all(torch.equal(x, y) for x, y in zip(tckpt._leaves(out), tckpt._leaves(carry)))
    # The window carry's leaves in the order of the JAX package's init_carry.
    from glio_tpu.config import GlioConfig as JGlioConfig
    from glio_tpu.models import sliding_window as jsw
    jcfg = JGlioConfig().replace(shapes=JGlioConfig().shapes.__class__(
        max_imu_per_interval=8, scan_points=16, map_points=64))
    jc = jsw.init_carry(jcfg, np.array([1.0, 2.0, 3.0]), np.array([1.0, 0, 0, 0]),
                        np.array([0.5, 0, 0]))
    jckpt.save_pytree(str(tmp_path / "j.npz"), jc)
    mine = tckpt.load_pytree(str(tmp_path / "j.npz"), est.make_initial_carry(
        [0.0, 0, 0], [1.0, 0, 0, 0], [0.0, 0, 0], n_imu=8).base)
    fresh = est.make_initial_carry([1.0, 2.0, 3.0], [1.0, 0, 0, 0], [0.5, 0, 0], n_imu=8).base
    assert all(torch.equal(x, y) for x, y in zip(tckpt._leaves(mine), tckpt._leaves(fresh)))


def test_timer_and_profiler():
    t = tprof.Timer("x")
    assert t.toc(verbose=False) >= 0.0
    prof = tprof.Profiler()
    for _ in range(2):
        with prof.section("work", sync=torch.ones(3)):
            sum(range(1000))
    assert prof.time_fn("fn", torch.ones, 4).shape == (4,)
    assert prof.counts["work"] == 2 and prof.counts["fn"] == 1
    rep = prof.report()
    assert "work" in rep and "fn" in rep and rep.splitlines()[0].startswith("section")
