"""Port parity: SPP, Doppler velocity, DOP and the GNSS_Tools helpers
(``gnss/spp.py``, ``gnss/tools.py``).

The epochs are the converted ones of the port's synthetic RINEX
(``testing.write_synthetic_rinex``, 60 epochs at 1 Hz, 8 GPS + 6 BDS), as the
JAX package converts them, so both sides read the same arrays. The JAX
package solves one epoch at a time under ``vmap``; the port solves every
epoch in one batched Gauss-Newton of (E, 7, 7) systems.

Tolerances: positions and clocks 1e-6 m, residual RMS 1e-8 m (8
Gauss-Newton steps from the same start with the normal equations summed in
another order: ~2e-9 m apart here), velocities and clock drift 1e-9 m/s,
DOPs 1e-12 relative; the ok masks, the PRN classes and the skyplot
projection exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glio_tpu.gnss import converter as j_conv
from glio_tpu.gnss import spp as j_spp
from glio_tpu.gnss import tools as j_tools
from glio_tpu_torch import testing
from glio_tpu_torch.config import GlioConfig
from glio_tpu_torch.gnss import dd as t_dd
from glio_tpu_torch.gnss import spp as t_spp
from glio_tpu_torch.gnss import tools as t_tools

STATION = np.asarray(GlioConfig().initialization.station_ecef)
SC = dict(testing.GNSS_DRIVE, n_keyframes=180)
POS_TOL_M = 1e-6


@pytest.fixture(scope="module", params=["GC", "G"])
def epochs(request, tmp_path_factory):
    d = tmp_path_factory.mktemp("spp")
    _, _, _, _, t_gps, rover = testing.gnss_drive(SC)
    obs, nav = str(d / "drive.obs"), str(d / "drive.nav")
    testing.write_synthetic_rinex(obs, nav, t_gps, rover, seed=SC["seed"],
                                  n_gps=SC["n_gps"], n_bds=SC["n_bds"])
    g = j_conv.convert(obs, nav, STATION, opts=j_conv.ConvertOptions(systems=request.param))
    return request.param, g, rover


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _spp_args(g):
    return (g.sat_pos, g.psr_rov_corr, g.system.astype(np.int32), g.valid, g.elevation, g.snr)


def test_solve_epochs_matches_jax(epochs):
    systems, g, rover = epochs
    x0 = STATION
    x_j, clk_j, ok_j, rms_j = (np.asarray(a) for a in j_spp.solve_epochs(
        *(jnp.asarray(a) for a in _spp_args(g)), jnp.asarray(x0)))
    x_t, clk_t, ok_t, rms_t = t_spp.solve_epochs(*(_t(a) for a in _spp_args(g)), _t(x0))
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    assert ok_t.all()
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=0, atol=POS_TOL_M)
    np.testing.assert_allclose(clk_t.numpy(), clk_j, rtol=0, atol=POS_TOL_M)
    np.testing.assert_allclose(rms_t.numpy(), rms_j, rtol=0, atol=1e-8)
    # The fixes land on the drive (0.5 m pseudorange noise, 8+ satellites).
    assert np.abs(x_t.numpy() - rover).max() < 10.0
    # A system with no satellites keeps its clock at 0; GLO and GAL always.
    assert (clk_t[:, 1:3] == 0).all()
    if systems == "G":
        assert (clk_t[:, 3] == 0).all()


def test_solve_epoch_matches_jax(epochs):
    _, g, _ = epochs
    for k in (0, 31):
        args = [a[k] for a in _spp_args(g)]
        out_j = j_spp.solve_epoch(*(jnp.asarray(a) for a in args), jnp.asarray(STATION))
        out_t = t_spp.solve_epoch(*(_t(a) for a in args), _t(STATION))
        assert bool(out_t[2]) == bool(out_j[2])
        np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]), rtol=0, atol=POS_TOL_M)


def test_doppler_velocity_matches_jax(epochs):
    _, g, rover = epochs
    args = (g.sat_pos, g.sat_vel, g.dopp_rov, g.system.astype(np.int32), g.valid,
            g.elevation, g.snr, rover)
    v_j, d_j = jax.vmap(j_spp.doppler_velocity)(*(jnp.asarray(a) for a in args))
    v_t, d_t = t_spp.doppler_velocity(*(_t(a) for a in args))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=0, atol=1e-9)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0, atol=1e-9)
    # The drive's speed (~12 m/s) and the receiver clock drift c·1e-8 s/s.
    v_true = np.gradient(rover, axis=0)
    assert np.abs(v_t.numpy() - v_true).max() < 0.5
    assert np.abs(d_t.numpy() - 299792458.0 * 1e-8).max() < 1.0


def test_elesnr_var_matches_jax(epochs):
    _, g, _ = epochs
    el, snr = g.elevation[g.valid], g.snr[g.valid]
    want = np.asarray(j_spp.elesnr_var(jnp.asarray(el), jnp.asarray(snr)))
    np.testing.assert_allclose(t_spp.elesnr_var(_t(el), _t(snr)).numpy(), want, rtol=1e-14)
    np.testing.assert_allclose(t_dd.elesnr_var_np(el, snr), want, rtol=1e-14)
    assert t_spp.elesnr_var is t_dd.elesnr_var          # one definition


def test_dop_matches_jax(epochs):
    _, g, rover = epochs
    out_t = t_tools.dop(_t(rover), _t(g.sat_pos), _t(g.valid))
    for k in range(0, g.time.shape[0], 9):
        out_j = j_tools.dop(jnp.asarray(rover[k]), jnp.asarray(g.sat_pos[k]),
                            jnp.asarray(g.valid[k]))
        for a, b in zip(out_t, out_j):
            np.testing.assert_allclose(a[k].numpy(), float(b), rtol=1e-12)
    gdop, pdop, hdop, vdop = (a.numpy() for a in out_t)
    assert (hdop < pdop).all() and (pdop < gdop).all() and (gdop < 10).all()


def test_classify_prn_and_skyplot_match_jax():
    prn = np.arange(-2, 200)
    np.testing.assert_array_equal(t_tools.classify_prn(prn), j_tools.classify_prn(prn))
    for f in ("prn_is_gps", "prn_is_glonass", "prn_is_beidou", "prn_is_gal"):
        np.testing.assert_array_equal(getattr(t_tools, f)(prn), getattr(j_tools, f)(prn))
    rng = np.random.default_rng(2)
    az, el = rng.uniform(-np.pi, np.pi, 50), rng.uniform(0, np.pi / 2, 50)
    for a, b in zip(t_tools.skyplot_coordinates(az, el), j_tools.skyplot_coordinates(az, el)):
        np.testing.assert_array_equal(a, b)


def test_spp_leading_axes(epochs):
    """Leading axes pass through: a (2, E/2) batch of epochs gives the same
    fixes as the flat (E,) call."""
    _, g, _ = epochs
    args = [_t(a) for a in _spp_args(g)]
    flat = t_spp.solve_epochs(*args, _t(STATION))
    E = g.time.shape[0]
    folded = t_spp.solve_epochs(*(a.reshape((2, E // 2) + a.shape[1:]) for a in args),
                                _t(STATION))
    np.testing.assert_allclose(folded[0].reshape(E, 3).numpy(), flat[0].numpy(), rtol=0,
                               atol=1e-9)
