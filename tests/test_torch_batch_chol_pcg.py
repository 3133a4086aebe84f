"""Port parity: the ``chol_pcg`` solver (``solver/banded.py``: the f32 band
factor, its apply and breakdown rule, ``pcg_chol_solve``; ``optimize_batch``
with ``solver="chol_pcg"``) against the JAX package, on the Doppler batch's
scenario (``tests/test_torch_batch_doppler.py``) and on a T = 300 chain of it
where 14 CG iterations stop short.

Tolerances: with ``chol_pcg``, JAX's own result moves by up to 8.4e-10 m
under a ±1e-9 m nudge of the odometry (the f32 preconditioner's rounding;
measured on this scenario), so the port is held to 1e-8 m of it, about 10x
that spread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glio_tpu.data.simulator import simulate_gnss_epochs
from glio_tpu.models import batch as JB
from glio_tpu.solver import banded as JBand
from glio_tpu_torch import convert
from glio_tpu_torch.data.simulator import drifted_trajectory
from glio_tpu_torch.models import batch as TB
from glio_tpu_torch.solver import banded as TBand
from test_torch_batch_doppler import ANCHOR, CFG, HW, ROBUST, STATION, scenario  # noqa: F401

CHOL_PCG_TOL_M = 1e-8


@pytest.fixture(scope="module")
def stiff_band():
    """A long stiff chain where 14 CG iterations stop short: the Doppler
    batch's band at T = 300 (the truth, threshold 6, the bench robust
    options, damping 1e-6), on which JAX's ``chol_pcg`` lies 2.7e-3 of |x|
    from the exact step."""
    T = 300
    kf_time, p_true, q_true, p_odo = drifted_trajectory(T)
    gnss = simulate_gnss_epochs(p_true, kf_time, ANCHOR, STATION, psr_noise=0.5, seed=4)
    prob_j = JB.build_problem(CFG, p_odo, q_true, kf_time, gnss, ANCHOR, 0.0, STATION)
    prob_t = convert.batch_problem_from_numpy(jax.tree.map(np.asarray, prob_j), "cpu")
    band, grad, *_ = TB._assemble_core_impl(torch.tensor(p_true), torch.tensor(q_true), prob_t,
                                            6.0, HW, robust=TB.RobustOpts(**ROBUST),
                                            use_doppler=True)
    TB._damp(band, torch.tensor(1e-6, dtype=torch.float64), HW)
    return band, -grad


def _jax_precond(band):
    """JAX's equilibrated f32 factor (broken rows the identity, as in
    ``_f32_chol_precond``) and its apply."""
    band_j = jnp.asarray(band.numpy())
    Lb = np.array(JBand.block_cholesky(JBand._equilibrate(band_j)[0].astype(jnp.float32),
                                       jitter=3e-4))
    bad = ~np.isfinite(Lb).all(axis=(1, 2, 3))
    Lb[bad] = 0.0
    Lb[bad, 0] = np.eye(Lb.shape[-1])
    apply = JBand._f32_chol_precond(band_j)
    return Lb, bad, lambda r: np.asarray(apply(jnp.asarray(r)))


def _rel(a, ref):
    return np.abs(a - ref).max() / np.abs(ref).max()


def _block_row_apply(M, r):
    """``_f32_chol_precond``'s apply with the port's factor: the f32
    ``block_cholesky_solve`` of the equilibrated right-hand side."""
    return (TBand.block_cholesky_solve(M.Lb, (r * M.s).to(torch.float32)).double() * M.s).numpy()


def test_f32_chol_precond_matches_jax(stiff_band):
    """``f32_chol_precond`` is ``block_cholesky`` of the equilibrated f32
    band, bit for bit, and within f32 round-off of JAX's factor (5.1e-6 of
    its largest entry, measured); its apply is that factor's block-row
    solve in f32, bit for bit, and within 2e-5 of JAX's apply (relative
    max-norm). A factor taken one 42 x 42 super-row at a time lies 1.1e-4
    from JAX's apply here, and fails."""
    band, b = stiff_band
    Lb_j, bad_j, apply_j = _jax_precond(band)
    assert not bad_j.any()
    M = TBand.f32_chol_precond(band)
    band_s, s = TBand._equilibrate(band)
    assert torch.equal(M.s, s)
    assert torch.equal(M.Lb, TBand.block_cholesky(band_s.to(torch.float32), jitter=3e-4))
    assert _rel(M.Lb.numpy(), Lb_j) < 2e-5
    r = torch.tensor(np.random.default_rng(0).normal(size=tuple(b.shape)))
    z = TBand.f32_chol_apply(M, r).numpy()
    np.testing.assert_array_equal(z, _block_row_apply(M, r))
    assert _rel(z, apply_j(r.numpy())) < 2e-5


def test_pcg_chol_solve_unconverged_matches_jax(stiff_band):
    """On the stiff chain the 14 iterations stop 9.4e-3 short of the exact
    step (|x| 3.5); the port's result lies 5.0e-6 from JAX's (measured)."""
    band, b = stiff_band
    x_j = np.asarray(JBand.pcg_chol_solve(jnp.asarray(band.numpy()), jnp.asarray(b.numpy())))
    x = TBand.direct_solve(band, b).numpy()
    assert _rel(x_j, x) > 1e-3
    x_t = TBand.pcg_chol_solve(band, b).numpy()
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=2e-5)


def _broken(band):
    """The band with block row 150's diagonal block negated: indefinite."""
    band = band.clone()
    band[150, HW] = -band[150, HW]
    return band


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_block_cholesky_breakdown_stays_in_its_row(stiff_band, dtype):
    """A block row whose Schur complement is indefinite gives NaN in that
    row alone: JAX's column guard zeroes it below, and so does the port's."""
    band = _broken(stiff_band[0])
    band_s, _ = TBand._equilibrate(band)
    L_j = np.asarray(JBand.block_cholesky(jnp.asarray(band_s.to(dtype).numpy()),
                                          jitter=3e-4))
    L_t = TBand.block_cholesky(band_s.to(dtype), jitter=3e-4).numpy()
    bad_j = ~np.isfinite(L_j).all(axis=(1, 2, 3))
    bad_t = ~np.isfinite(L_t).all(axis=(1, 2, 3))
    assert np.nonzero(bad_j)[0].tolist() == [150]
    np.testing.assert_array_equal(bad_t, bad_j)
    for m in range(1, HW + 1):       # L[150 + m][150], column 150 below the break
        assert np.all(L_t[150 + m, m] == 0) and np.all(L_j[150 + m, m] == 0)


def test_f32_chol_precond_breakdown_matches_jax(stiff_band):
    """The broken block row becomes the identity, as in JAX, and the apply,
    still the f32 block-row solve bit for bit, matches JAX's."""
    band = _broken(stiff_band[0])
    Lb_j, bad_j, apply_j = _jax_precond(band)
    M = TBand.f32_chol_precond(band)
    assert np.nonzero(bad_j)[0].tolist() == [150]
    np.testing.assert_array_equal(M.Lb[150].numpy(), Lb_j[150])
    assert _rel(M.Lb.numpy(), Lb_j) < 2e-5
    r = np.random.default_rng(1).normal(size=tuple(stiff_band[1].shape))
    z = TBand.f32_chol_apply(M, torch.tensor(r)).numpy()
    np.testing.assert_array_equal(z, _block_row_apply(M, torch.tensor(r)))
    assert _rel(z, apply_j(r)) < 2e-5


def test_pcg_chol_solve_matches_jax():
    """The f32-preconditioned CG on a banded SPD system (hw 3, 50 block
    rows), where 14 iterations converge, 14 iterations each."""
    rng = np.random.default_rng(0)
    T, hw, D = 50, 3, 6
    n = T * D
    J = np.zeros((n + 30, n))
    for r in range(J.shape[0]):
        c = rng.integers(0, n - hw * D)
        J[r, c:c + hw * D] = rng.normal(size=hw * D) * rng.choice([1.0, 3.0, 10.0])
    H = J.T @ J + 0.1 * np.eye(n)
    band = np.zeros((T, 2 * hw + 1, D, D))
    for t in range(T):
        for o in range(2 * hw + 1):
            j = t + o - hw
            if 0 <= j < T:
                band[t, o] = H[t * D:(t + 1) * D, j * D:(j + 1) * D]
    b = rng.normal(size=(T, D))
    x_j = np.asarray(JBand.pcg_chol_solve(jnp.asarray(band), jnp.asarray(b)))
    x_t = TBand.pcg_chol_solve(torch.tensor(band), torch.tensor(b)).numpy()
    x = np.linalg.solve(H, b.reshape(-1)).reshape(T, D)
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(x_t, x, rtol=0, atol=1e-7 * np.abs(x).max())


@pytest.mark.parametrize("doppler", [False, True], ids=["dd", "dd_doppler"])
def test_optimize_batch_chol_pcg_matches_jax(scenario, doppler):
    s = scenario
    est = dataclasses.replace(CFG.estimator, doppler_in_batch=doppler, batch_solver="chol_pcg")
    cfg = CFG.replace(estimator=est)
    kw = dict(thresholds=(1e9, 6.0), lm_iters=3, solver="chol_pcg")
    p_j, q_j, _ = JB.optimize_batch(cfg, s["prob_j"], robust=JB.RobustOpts(**ROBUST),
                                    mixed=False, **kw)
    p_t, q_t, _ = TB.optimize_batch(convert.config_from_glio(cfg), s["prob_t"],
                                    robust=TB.RobustOpts(**ROBUST), **kw)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0, atol=CHOL_PCG_TOL_M)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), rtol=0, atol=CHOL_PCG_TOL_M / 10)
