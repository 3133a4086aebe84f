"""Port parity: the batch variants (``models/batch.py``: ``optimize_batch_atm``,
``derive_relatives``, ``optimize_batch_reference_cadence``,
``optimize_batch_incremental``) and ``factors/pose.py`` against the JAX
package.

The problem is ``tests/test_batch.py``'s: T = 120 keyframes of a 3 Hz drive
with a quadratic odometry drift to ~6 m and simulated GNSS every third
keyframe (seed 4). JAX builds it; both sides solve it in f64 (the JAX
package's ``mixed=False``, the port's arithmetic), JAX's defaults of
``mixed=True`` inside the cadence and incremental modes patched to f64.

Tolerances (measured once on the CPU). ``direct`` is the same f64
arithmetic on both sides up to round-off, which the LM leaves at 3e-12 m:
positions and zenith biases are held to 1e-7 m, quaternions to 1e-9.
``chol_pcg`` stops 14 CG iterations short with an f32 preconditioner:
1.5e-7 m apart, held to 1e-6 m and 1e-8. ``pcg`` stops 200 block-Jacobi
iterations short on this stiff chain, where round-off steers the Krylov
iterates: a ±1e-9 m nudge of the LM's start moves JAX's own result by
5.2e-4 m in p, 7.4e-4 m in z and 3.3e-6 in q, and the port is held to 10x
that. The incremental modes chain odometry hops on the host and re-derive
the relatives from each result: 1e-6 m and 1e-8.
"""

import functools
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glio_tpu.config import GlioConfig
from glio_tpu.data.simulator import simulate_gnss_epochs
from glio_tpu.factors import pose as JP
from glio_tpu.models import batch as JB
from glio_tpu.utils import quat as JQ
from glio_tpu_torch import convert
from glio_tpu_torch.factors import pose as TP
from glio_tpu_torch.models import batch as TB

ANCHOR = np.array([-2419233.42, 5385473.13, 2405341.30])
STATION = np.array([-2414266.92, 5386768.987, 2407460.031])
CFG = GlioConfig()
TCFG = convert.config_from_glio(CFG)
P_TOL, Q_TOL = 1e-7, 1e-9
ATM_TOL = {"direct": (P_TOL, Q_TOL, P_TOL), "chol_pcg": (1e-6, 1e-8, 1e-6),  # p, q, z
           "pcg": (5.2e-3, 3.3e-5, 7.4e-3)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    """``tests/test_batch.py::problem``."""
    T = 120
    kf_time = np.arange(T) / 3.0
    th = np.linspace(0, 3, T)
    p_true = np.stack([40 * th, 15 * np.sin(th), 0.5 * th], -1)
    yaw = np.gradient(p_true[:, 1], p_true[:, 0] + 1e-9) * 0.3
    q_true = np.asarray(JQ.from_ypr(jnp.asarray(np.stack([yaw, 0 * yaw, 0 * yaw], -1))))
    drift = np.stack([0.0005 * np.arange(T) ** 2, -0.0003 * np.arange(T) ** 2,
                      0.0002 * np.arange(T) ** 2], -1)
    p_odo = p_true + drift
    gnss = simulate_gnss_epochs(p_true, kf_time, ANCHOR, STATION, psr_noise=0.5, seed=4)
    prob = JB.build_problem(CFG, p_odo, q_true, kf_time, gnss, ANCHOR, 0.0, STATION)
    prob_t = convert.batch_problem_from_numpy(jax.tree.map(np.asarray, prob), "cpu")
    return prob, prob_t, kf_time, p_true


def _close(got, want, tol, name):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else got, np.asarray(want),
                               rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("solver", ["direct", "pcg", "chol_pcg"])
def test_optimize_batch_atm_matches_jax(problem, solver):
    """The 7-dof solve (pose + zenith bias) with the bench's robust options:
    p, q, z and the per-stage costs."""
    prob, prob_t, _, p_true = problem
    robust = dict(dd_huber=1.0, epoch_gate=2.0, rel_huber=5.0)
    p_j, q_j, z_j, c_j = JB.optimize_batch_atm(CFG, prob, lm_iters=3, solver=solver,
                                               robust=JB.RobustOpts(**robust), mixed=False)
    p_t, q_t, z_t, c_t = TB.optimize_batch_atm(TCFG, prob_t, lm_iters=3, solver=solver,
                                               robust=TB.RobustOpts(**robust))
    tol_p, tol_q, tol_z = ATM_TOL[solver]
    _close(p_t, p_j, tol_p, "p")
    _close(q_t, q_j, tol_q, "q")
    _close(z_t, z_j, tol_z, "z")
    np.testing.assert_allclose(c_t, c_j, rtol=1e-10 if solver == "direct" else 1e-4)
    assert float(z_t.abs().max()) > 1e-3          # the chain moved
    e = np.linalg.norm(p_t.numpy() - p_true, axis=-1)
    assert e.mean() < np.linalg.norm(prob_t.p_odo.numpy() - p_true, axis=-1).mean()


def test_optimize_batch_atm_refuses_doppler(problem):
    prob_t = problem[1]
    cfg = TCFG.replace(estimator=TCFG.estimator.__class__(
        **{**TCFG.estimator.__dict__, "doppler_in_batch": True}))
    with pytest.raises(ValueError, match="doppler_in_batch"):
        TB.optimize_batch_atm(cfg, prob_t)


def test_atm_assembly_keeps_level0_bits(problem):
    """With the z chain the band grows a seventh row and column; its pose
    corner is level 0's band to the bit when z is zero (the z column of the
    DD rows then adds nothing)."""
    prob_t = problem[1]
    hw = CFG.estimator.search_range + 1
    band6, grad6, *_ = TB._assemble_core_impl(prob_t.p_odo, prob_t.q_odo, prob_t, 10.0, hw)
    z = torch.zeros(prob_t.p_odo.shape[0], dtype=torch.float64)
    band7, grad7, *_ = TB._assemble_core_impl(prob_t.p_odo, prob_t.q_odo, prob_t, 10.0, hw,
                                              z=z)
    assert band7.shape[-1] == 7 and grad7.shape[-1] == 7
    np.testing.assert_allclose(band7[..., :6, :6].numpy(), band6.numpy(), rtol=0,
                               atol=1e-12 * float(band6.abs().max()))
    assert float(band7[..., 6, 6].abs().max()) > 0


def test_derive_relatives_matches_jax(problem):
    prob, prob_t, kf_time, _ = problem
    R = prob_t.rel_valid.shape[1]
    got = TB.derive_relatives(prob_t.p_odo, prob_t.q_odo, 1 / 3.0, R)
    want = JB.derive_relatives(prob.p_odo, prob.q_odo, 1 / 3.0, R)
    for name, a, b in zip(("dp", "dq", "valid"), got, want):
        if name == "valid":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            _close(a, b, 1e-12, name)


def _f64(fn):
    """A JAX batch mode with its inner solves patched to f64."""
    ob = functools.partial(JB.optimize_batch, mixed=False)
    orig = JB.solve_batch_once

    def sb(*args, **kw):      # optimize_batch passes ``mixed`` as its tenth argument
        if len(args) < 10:
            kw.setdefault("mixed", False)
        return orig(*args, **kw)
    with unittest.mock.patch.object(JB, "optimize_batch", ob), \
            unittest.mock.patch.object(JB, "solve_batch_once", sb):
        return fn()


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_reference_cadence_matches_jax(problem, warm):
    """Re-solves every 40 keyframes (30, 70, 110), then the full problem:
    the result is ``optimize_batch`` of the whole problem, bit for bit, and
    JAX's within round-off."""
    prob, prob_t, _, _ = problem
    kw = dict(every=40, lm_iters=3, final_lm_iters=5, warm_start=warm, warm_lm_iters=3)
    p_j, q_j, st_j = _f64(lambda: JB.optimize_batch_reference_cadence(CFG, prob, **kw))
    p_t, q_t, st_t = TB.optimize_batch_reference_cadence(TCFG, prob_t, **kw)
    assert st_t["n_resolves"] == st_j["n_resolves"] == 3
    assert 0 < st_t["resolve_max_s"] and st_t["total_s"] >= st_t["final_s"] > 0
    p_once, q_once, _ = TB.optimize_batch(TCFG, prob_t, lm_iters=5)
    assert torch.equal(p_t, p_once) and torch.equal(q_t, q_once)
    _close(p_t, p_j, P_TOL, "p")
    _close(q_t, q_j, Q_TOL, "q")


def test_mask_prefix_matches_jax(problem):
    prob, prob_t, _, _ = problem
    for n in (30, 70, 119):
        got = TB._mask_prefix(prob_t.rel_valid, prob_t.ep_valid, prob_t.ep_left, n)
        want = JB._mask_prefix(prob.rel_valid, prob.ep_valid, prob.ep_left,
                               jnp.asarray(n, jnp.int32))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("rederive", [True, False], ids=["rederive", "original"])
def test_optimize_batch_incremental_matches_jax(problem, rederive):
    """Re-solves every 40 keyframes, the hops chained on the host, then two
    relaxation passes (with ``rederive``)."""
    prob, prob_t, kf_time, p_true = problem
    kw = dict(every=40, lm_iters=3, rederive=rederive,
              relaxation_passes=2 if rederive else 0)
    p_j, q_j = _f64(lambda: JB.optimize_batch_incremental(CFG, prob, kf_time, **kw))
    p_t, q_t = TB.optimize_batch_incremental(TCFG, prob_t, kf_time, **kw)
    _close(p_t, p_j, 1e-6, "p")
    _close(q_t, q_j, 1e-8, "q")
    e0 = np.linalg.norm(prob_t.p_odo.numpy() - p_true, axis=-1).mean()
    assert np.linalg.norm(p_t.numpy() - p_true, axis=-1).mean() < e0


def test_original_hops_and_chain_match_jax(problem):
    prob, prob_t, _, _ = problem
    got, want = TB._original_hops(prob_t), JB._original_hops(prob)
    for a, b in zip(got, want):
        _close(a, b, 1e-12, "hops")
    p_t, q_t = (np.zeros((120, 3)), np.tile([1.0, 0, 0, 0], (120, 1)))
    p_j, q_j = p_t.copy(), q_t.copy()
    TB._chain_hops(p_t, q_t, *got, 0, 120)
    JB._chain_hops(p_j, q_j, *want, 0, 120)
    _close(p_t, p_j, 1e-9, "p")
    _close(q_t, q_j, 1e-12, "q")


# --- factors/pose.py ---------------------------------------------------------------

def _poses(rng, n):
    q = rng.normal(size=(n, 4))
    return rng.normal(size=(n, 3)) * 10, q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_pose_factors_match_jax():
    """Every residual of ``factors/pose.py`` on random poses, masks and
    weights, to 1e-12 (f64 quaternion products in both)."""
    rng = np.random.default_rng(11)
    n = 50
    (p1, q1), (p2, q2), (dp, dq) = _poses(rng, n), _poses(rng, n), _poses(rng, n)
    mask = rng.uniform(size=n) > 0.3
    w_q, w_p = rng.uniform(1, 20, size=n), 0.2
    t = lambda a: torch.as_tensor(a)
    j = lambda a: jnp.asarray(a)
    _close(TP.relative_pose_residual(t(p1), t(q1), t(p2), t(q2), t(dp), t(dq), t(w_q), w_p,
                                     t(mask)),
           JP.relative_pose_residual(j(p1), j(q1), j(p2), j(q2), j(dp), j(dq), j(w_q), w_p,
                                     j(mask)), 1e-12, "relative")
    for left in (True, False):
        _close(TP.anchored_pose_residual(t(p1), t(q1), t(p2), t(q2), t(dp), t(dq), 0.2,
                                         t(mask), anchor_is_left=left),
               JP.anchored_pose_residual(j(p1), j(q1), j(p2), j(q2), j(dp), j(dq), 0.2,
                                         j(mask), anchor_is_left=left), 1e-12, "anchored")
    for m in (None, mask):
        mt = None if m is None else t(m)
        mj = None if m is None else j(m)
        _close(TP.position_prior_residual(t(p1), t(p2), mask=mt),
               JP.position_prior_residual(j(p1), j(p2), mask=mj), 1e-12, "position prior")
        v = [rng.normal(size=(n, 3)) for _ in range(6)]
        _close(TP.speed_bias_prior_residual(*map(t, v), mask=mt),
               JP.speed_bias_prior_residual(*map(j, v), mask=mj), 1e-12, "speed-bias prior")
