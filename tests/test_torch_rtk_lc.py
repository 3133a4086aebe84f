"""Port parity: stage 3's RTK DD fixes (``gnss/rtk.py``) and the
loosely-coupled fusion (``models/lc_fusion.py``) against the JAX package.

Both sides get the same numpy inputs. The DD fix is the same f64 Gauss-
Newton on the same weights: positions to 1e-6 m and covariances to 1e-6
relative (measured: 0 m and 3e-15 on the exact-geometry epoch). The LC
chain is the same damped GN with the same accept/reject; the band and
gradient are held to 1e-9 relative (forward-mode Jacobians on both sides,
f64 round-off) and the solution to 1e-7 m.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glio_tpu.gnss import rtk as JR
from glio_tpu.models import lc_fusion as JL
from glio_tpu_torch.data.simulator import drifted_trajectory, simulate_gnss_epochs
from glio_tpu_torch.gnss import dd as dd_mod
from glio_tpu_torch.gnss import rtk
from glio_tpu_torch.models import lc_fusion
from glio_tpu_torch.config import GlioConfig

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CFG = GlioConfig()
ANCHOR = np.asarray(CFG.initialization.anc_ecef)
STATION = np.asarray(CFG.initialization.station_ecef)


def _exact_epoch(nlos: bool):
    """One epoch of 16 satellites, the rover 500/−300/200 m from the station
    (``tests/test_pipeline_aux.py::test_rtk_dd_fix_synthetic``), optionally
    with a 120 m NLOS bias on satellite 5."""
    rng = np.random.default_rng(3)
    M = 16
    station = np.array([-2414266.92, 5386768.987, 2407460.031])
    truth = station + np.array([500.0, -300.0, 200.0])
    dirs = rng.normal(size=(M, 3))
    dirs[:, 2] = np.abs(dirs[:, 2]) + 0.5
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    sat_pos = station + 2.2e7 * (dirs + station / np.linalg.norm(station))
    psr_rov = np.linalg.norm(sat_pos - truth, axis=-1) + 123.4
    if nlos:
        psr_rov[5] += 120.0
    psr_sta = np.linalg.norm(sat_pos - station, axis=-1)
    return (sat_pos, psr_rov, psr_sta, np.ones(M, bool), np.zeros(M, np.int32),
            np.array([0, -1, -1, -1], np.int32), station, np.full(M, 0.8),
            np.full(M, 45.0), station), truth


def _epochs():
    """33 simulated epochs over a 100-keyframe drive, all four systems."""
    kf_time, p_true, _, _ = drifted_trajectory(100)
    g = simulate_gnss_epochs(p_true, kf_time, ANCHOR, STATION, psr_noise=0.5, seed=4)
    return (g.sat_pos, g.psr_rov, g.psr_sta, g.valid, g.system.astype(np.int32), g.master,
            STATION, g.elevation, g.snr, ANCHOR)


def _port(args):
    return [torch.as_tensor(np.asarray(a)) for a in args]


def test_elesnr_var_equals_numpy():
    rng = np.random.default_rng(0)
    el, snr = rng.uniform(0, 1.5, 100), rng.uniform(20, 50, 100)
    np.testing.assert_allclose(dd_mod.elesnr_var(torch.tensor(el), torch.tensor(snr)).numpy(),
                               dd_mod.elesnr_var_np(el, snr), rtol=1e-14)


@pytest.mark.parametrize("nlos", [False, True])
@pytest.mark.parametrize("robust", [{}, dict(iters=12, huber=3.0, trim=30.0)])
def test_solve_epoch_dd_matches_jax(nlos, robust):
    args, truth = _exact_epoch(nlos)
    pj, cj, okj, nj = JR.solve_epoch_dd(*[jnp.asarray(a) for a in args], **robust)
    pt, ct, okt, nt = rtk.solve_epoch_dd(*_port(args), **robust)
    assert bool(okt) == bool(okj) and int(nt) == int(nj) == 15
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(cj)).max())
    if not nlos or robust:
        np.testing.assert_allclose(pt.numpy(), truth, rtol=0, atol=1e-2)


@pytest.mark.parametrize("robust", [{}, dict(huber=3.0, trim=30.0)])
def test_solve_epochs_dd_matches_jax(robust):
    args = _epochs()
    pj, cj, okj, nj = JR.solve_epochs_dd(*[jnp.asarray(a) for a in args], **robust)
    pt, ct, okt, nt = rtk.solve_epochs_dd(*_port(args), **robust)
    assert pt.shape == (len(args[0]), 3) and okt.all()
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6,
                               atol=1e-9 * np.abs(np.asarray(cj)).max())


def _lc_inputs(T=80, seed=5):
    """A drifted odometry chain with noisy fixes on two keyframes in three,
    some closer than the 5 m spacing gate and two gross outliers."""
    _, p_true, q_true, p_odo = drifted_trajectory(T, max_drift=4.0)
    rng = np.random.default_rng(seed)
    valid = np.arange(T) % 3 != 1
    gnss_p = p_true + rng.normal(scale=0.5, size=p_true.shape)
    gnss_p[[20, 50]] += np.array([30.0, -20.0, 5.0])
    sigma = rng.uniform(0.3, 2.0, T)
    return p_odo, q_true, gnss_p, valid, sigma


def test_build_problem_matches_jax():
    args = _lc_inputs()
    j = JL.build_problem(*args)
    t = lc_fusion.build_problem(*args, device="cpu")
    np.testing.assert_array_equal(t.gnss_valid.numpy(), np.asarray(j.gnss_valid))
    assert 0 < int(t.gnss_valid.sum()) < int(args[3].sum())     # the spacing gate acted
    for f in ("rel_dp", "rel_dq", "gnss_p", "w_gnss", "p0", "q0"):
        np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                   rtol=1e-14, atol=1e-14, err_msg=f)
    assert t.w_rel_p == float(j.w_rel_p) and t.w_rel_q == float(j.w_rel_q)


@pytest.mark.parametrize("huber", [0.0, 1.5])
def test_assemble_matches_jax(huber):
    args = _lc_inputs()
    j = JL.build_problem(*args)
    t = lc_fusion.build_problem(*args, device="cpu")
    rng = np.random.default_rng(1)
    p = args[0] + rng.normal(scale=0.3, size=args[0].shape)
    q = args[1] + rng.normal(scale=0.01, size=args[1].shape)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pj, qj = jnp.asarray(p), jnp.asarray(q)
    pt, qt = torch.tensor(p), torch.tensor(q)
    w_j = JL._gnss_irls(pj, j, huber) if huber else None
    w_t = lc_fusion._gnss_irls(pt, t, huber) if huber else None
    if huber:
        np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-12)
    band_j, grad_j = JL._assemble(pj, qj, j, w_j)
    band_t, grad_t = lc_fusion._assemble(pt, qt, t, w_t)
    band_j, grad_j = np.asarray(band_j), np.asarray(grad_j)
    np.testing.assert_allclose(band_t.numpy(), band_j, rtol=0, atol=1e-9 * np.abs(band_j).max())
    np.testing.assert_allclose(grad_t.numpy(), grad_j, rtol=0, atol=1e-9 * np.abs(grad_j).max())
    np.testing.assert_allclose(float(lc_fusion._residual_cost(pt, qt, t, w_t)),
                               float(JL._residual_cost(pj, qj, j, w_j)), rtol=1e-12)


@pytest.mark.parametrize("huber", [0.0, 1.5])
def test_solve_matches_jax(huber):
    args = _lc_inputs()
    j = JL.build_problem(*args)
    t = lc_fusion.build_problem(*args, device="cpu")
    pj, qj, cj = JL.solve(j, jnp.asarray(args[0]), jnp.asarray(args[1]), gnss_huber=huber)
    pt, qt, ct = lc_fusion.solve(t, torch.tensor(args[0]), torch.tensor(args[1]),
                                 gnss_huber=huber)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-7)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-9)


def test_stage3_at_whampoa_length_matches_fixture():
    """``chip_smoke.py``'s stage-3 phase on the CPU: 1165 DD fixes and the
    LC solve at T = 3493 against ``tests/data/lc_T3493_seed4.npz``, with the
    card's gates (fixes within 10x JAX's spread under a 1e-8 m alternating
    pseudorange nudge, p and q within 10x its spread under a 1e-9 m nudge
    of the odometry; ok masks and the gated factors equal)."""
    import chip_smoke
    chip_smoke.lc_phase(torch.device("cpu"))
