"""Port parity: the carrier-phase path (``gnss/rtk.py``'s float filter,
``gnss/lambda_ar.py``, ``pipeline.float_ar_fixes`` / ``lc_stage_float_ar``)
against the JAX package.

Both sides get the same numpy inputs: ``simulate_gnss_epochs`` with carrier,
integer ambiguities of 0.19 m, cycle slips (``slip_prob`` 0.02) and 2 m code
noise, 60 epochs (the scenario of ``tests/test_lambda_ar.py``). The filter
is the same f64 recursion on both sides; the two differ in round-off only
(norms, matmul order, the Cholesky solves), which 60 epochs of carrier
updates carry to 1e-7 m (measured on this drive: the ECEF positions 1.9e-8
m, a few ulp, the ambiguities 9.5e-8 m; the covariances 2.2e-8 of their
largest entry), so positions, velocities and ambiguities are held to 1e-6 m
and the covariances to 1e-6 relative. The gates and the AR ratio test are
discrete; on this drive no row lies near one, so the counts and flags are
held equal.
"""

import ast
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glio_tpu.gnss import lambda_ar as JLA
from glio_tpu.gnss import rtk as JR
from glio_tpu.models import lc_fusion as JL
from glio_tpu.eval.trajectory import associate as jax_associate
from glio_tpu.utils import coords as JC
from glio_tpu_torch import pipeline
from glio_tpu_torch.data.simulator import drifted_trajectory, simulate_gnss_epochs
from glio_tpu_torch.gnss import lambda_ar, rtk

ROOT = pathlib.Path(__file__).resolve().parents[1]
ANCHOR = np.array([-2419233.42, 5385473.13, 2405341.30])
STATION = np.array([-2414266.92, 5386768.987, 2407460.031])
LAM = 0.19029367
POS_TOL, COV_RTOL = 1e-6, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """A long chain of small torch ops: one intra-op thread is as fast, and
    keeps a parallel run's workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drive(T=180):
    kf_time = np.arange(T) / 3.0
    th = np.linspace(0, 3, T)
    p_true = np.stack([40 * th, 15 * np.sin(th), 0.5 * th], -1)
    return kf_time, p_true


@pytest.fixture(scope="module")
def sim():
    kf_time, p_true = _drive()
    g = simulate_gnss_epochs(p_true, kf_time, ANCHOR, STATION, psr_noise=2.0, epoch_stride=3,
                             seed=31, carrier=True, car_noise=0.003, slip_prob=0.02,
                             amb_cycles_lambda=LAM)
    # One satellite (never a master) drops out for epochs 20-44: those epochs
    # have an even count of code rows (14; 15 elsewhere), its slot goes
    # through the filter's pad slot, and its arc restarts when it returns.
    span = slice(20, 45)
    masters = set(g.master[span].ravel().tolist())
    s = next(m for m in range(g.valid.shape[1]) if g.valid[span, m].all() and m not in masters)
    g.valid[span, s] = False
    g.car_valid[span, s] = False
    gt = np.asarray(JC.enu2ecef(jnp.asarray(p_true), jnp.asarray(ANCHOR)))[::3]
    return g, gt, kf_time, p_true


@pytest.fixture(scope="module")
def filters(sim):
    g, gt, _, _ = sim
    x0 = gt[0] + 5.0
    return JR.run_float_filter(g, STATION, x0), rtk.run_float_filter(g, STATION, x0,
                                                                      device="cpu")


def test_lambda_ar_is_a_copy():
    """The port's ``gnss/lambda_ar.py`` is the JAX package's, statement for
    statement (only the module docstring differs)."""
    def body(path):
        tree = ast.parse(path.read_text())
        tree.body = tree.body[1:]          # the docstring
        return ast.dump(tree)
    assert (body(ROOT / "glio_tpu_torch" / "gnss" / "lambda_ar.py")
            == body(ROOT / "glio_tpu" / "gnss" / "lambda_ar.py"))


def test_arc_tracking_matches_jax(sim):
    g = sim[0]
    assert np.asarray(g.lli).any()                  # the drive has cycle slips
    for a, b in zip(rtk.arc_tracking(g), JR.arc_tracking(g)):
        np.testing.assert_array_equal(a, b)


def test_float_filter_matches_jax(sim, filters):
    g, gt = sim[:2]
    out_j, out_t = filters
    assert out_t._fields == out_j._fields
    for name in ("ok", "n_dd", "n_car"):
        np.testing.assert_array_equal(getattr(out_t, name).numpy(),
                                      np.asarray(getattr(out_j, name)), err_msg=name)
    for name in ("pos", "vel", "amb"):
        np.testing.assert_allclose(getattr(out_t, name).numpy(),
                                   np.asarray(getattr(out_j, name)), rtol=0, atol=POS_TOL,
                                   err_msg=name)
    for name in ("pos_cov", "amb_var", "amb_cov", "pa_cov", "consist"):
        want = np.asarray(getattr(out_j, name))
        np.testing.assert_allclose(getattr(out_t, name).numpy(), want, rtol=0,
                                   atol=COV_RTOL * np.abs(want).max(), err_msg=name)
    # The filter works: well inside the 2 m code noise after convergence
    # (0.58 m median on this drive, with its slips and the dropout).
    err = np.linalg.norm(out_t.pos.numpy() - gt, axis=-1)[30:]
    assert np.median(err) < 1.0


def test_nanmedian_matches_jax_on_even_counts():
    """``jnp.nanmedian`` averages the two middle values of an even count;
    ``torch.nanmedian`` would take the lower one. Bit for bit, counts 0-9."""
    rng = np.random.default_rng(5)
    x = rng.exponential(size=(200, 9))
    mask = np.zeros((200, 9), bool)
    for i in range(200):
        mask[i, rng.permutation(9)[:i % 10]] = True
    got = rtk._nanmedian(torch.tensor(x), torch.tensor(mask)).numpy()
    want = np.asarray(jnp.nanmedian(jnp.where(jnp.asarray(mask), jnp.asarray(x), jnp.nan),
                                    axis=-1))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    assert not np.array_equal(got[mask.sum(1) == 4],
                              torch.nanmedian(torch.tensor(np.where(mask, x, np.nan)),
                                              dim=-1)[0].numpy()[mask.sum(1) == 4])


def test_float_filter_epochs_with_even_code_counts(sim, filters):
    """The drive has epochs whose count of valid code rows is even (the
    median of their chi-square averages two values), and the consistency
    factor, which every reported covariance carries, follows JAX's there."""
    out_j, out_t = filters
    n = out_t.n_dd.numpy()
    even = (n % 2 == 0) & (n >= 4)
    assert even.sum() == 25 and (n[~even] == 15).all()
    np.testing.assert_allclose(out_t.consist.numpy()[even], np.asarray(out_j.consist)[even],
                               rtol=COV_RTOL)


def test_float_filter_without_carrier_matches_jax(sim):
    """No carrier (``car_rov`` None): code and Doppler only; no ``sat_id``:
    every satellite a fresh arc at every epoch. (Without carrier the JAX
    package's arc tracking needs ``sat_id`` absent too: it reads
    ``car_valid``. The port's copy does the same.)"""
    g, gt = sim[:2]
    for drop in (("car_rov", "car_sta", "car_valid", "sat_id"), ("sat_id",)):
        kw = {f: None for f in drop}
        g2 = dataclasses.replace(g, **kw)
        out_j = JR.run_float_filter(g2, STATION, gt[0] + 5.0)
        out_t = rtk.run_float_filter(g2, STATION, gt[0] + 5.0, device="cpu")
        np.testing.assert_array_equal(out_t.ok.numpy(), np.asarray(out_j.ok))
        if drop[0] == "car_rov":
            assert int(out_t.n_car.sum()) == 0
        for name in ("pos", "vel"):
            np.testing.assert_allclose(getattr(out_t, name).numpy(),
                                       np.asarray(getattr(out_j, name)), rtol=0, atol=POS_TOL,
                                       err_msg=f"{drop}: {name}")
        want = np.asarray(out_j.pos_cov)
        np.testing.assert_allclose(out_t.pos_cov.numpy(), want, rtol=0,
                                   atol=COV_RTOL * np.abs(want).max())


def test_resolve_trajectory_on_port_output_matches_jax(sim, filters):
    g, gt = sim[:2]
    out_j, out_t = filters
    pos_j, fixed_j, ratio_j = JLA.resolve_trajectory(g, out_j, wavelength=LAM)
    host = pipeline._to_host(out_t)
    pos_t, fixed_t, ratio_t = lambda_ar.resolve_trajectory(g, host, wavelength=LAM)
    np.testing.assert_array_equal(fixed_t, fixed_j)
    assert fixed_t[30:].mean() > 0.3                 # AR fixes a meaningful share
    np.testing.assert_allclose(pos_t, pos_j, rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(ratio_t, ratio_j, rtol=1e-6)
    err_fix = np.linalg.norm(pos_t - gt, axis=-1)[30:][fixed_t[30:]]
    assert np.median(err_fix) < 0.05


def test_to_host_is_one_copy_of_every_field(filters):
    out_t = filters[1]
    host = pipeline._to_host(out_t)
    for a, b in zip(host, out_t):
        assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy())


def _jax_float_ar_lc(g, kf_time, p_sw, q_sw, x0):
    """``tests/test_lc_fusion.py:170-200``'s composition, in JAX (scalar λ
    for the simulated constellation)."""
    flt = JR.run_float_filter(g, STATION, x0)
    sig = np.sqrt(np.maximum(np.trace(np.asarray(flt.pos_cov), axis1=1, axis2=2) / 3, 1e-6))
    ok = np.asarray(flt.ok) & (sig < 5.0)
    pos_ar, fixed, _ = JLA.resolve_trajectory(g, flt, wavelength=LAM)
    fixes = np.asarray(flt.pos).copy()
    fixes[fixed] = pos_ar[fixed]
    sig = np.where(fixed, np.minimum(sig, 0.5), sig)
    enu_fix = np.asarray(JC.ecef2enu(jnp.asarray(fixes), jnp.asarray(ANCHOR)))
    T = p_sw.shape[0]
    ia, ib = jax_associate(kf_time, g.time, max_dt=0.25)
    gp, gv, gs = np.zeros((T, 3)), np.zeros(T, bool), np.ones(T)
    for a, b in zip(ia, ib):
        if ok[b]:
            gp[a] = enu_fix[b]
            gv[a] = True
            gs[a] = max(sig[b], 0.5)
    prob = JL.build_problem(p_sw, q_sw, gp, gv, gs, min_spacing_m=5.0)
    p, q, _ = JL.solve(prob, jnp.asarray(p_sw), jnp.asarray(q_sw), gn_iters=8, pcg_iters=400,
                       gnss_huber=2.0)
    return np.asarray(p), np.asarray(q), (gp, gv, gs, fixed)


def test_lc_stage_float_ar_matches_jax(sim):
    """The float/AR LC helper against the JAX composition, on a drifted
    odometry of the drive: the gated, associated fixes equal to 1e-8 m, the
    LC chain to 1e-7 m (the stage-3 tests' tolerance)."""
    g, gt, kf_time, p_true = sim
    _, _, q_true, p_odo = drifted_trajectory(kf_time.shape[0], 6.0)
    p_odo = p_odo - p_odo[0] + p_true[0]
    p_j, q_j, (gp, gv, gs, fixed_j) = _jax_float_ar_lc(g, kf_time, p_odo, q_true, gt[0] + 5.0)
    tm = {}
    p_t, q_t, flt, got, fixed_t = pipeline.lc_stage_float_ar(
        g, kf_time, p_odo, q_true, ANCHOR, 0.0, STATION, device="cpu", x0=gt[0] + 5.0,
        wavelength=LAM, timings=tm)
    assert sorted(tm) == ["ar", "filter", "lc"]
    np.testing.assert_array_equal(fixed_t, fixed_j)
    np.testing.assert_array_equal(got[1], gv)
    np.testing.assert_allclose(got[0], gp, rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(got[2], gs, rtol=1e-9)
    assert gv.sum() > 20
    np.testing.assert_allclose(p_t.numpy(), p_j, rtol=0, atol=1e-7)
    np.testing.assert_allclose(q_t.numpy(), q_j, rtol=0, atol=1e-9)
