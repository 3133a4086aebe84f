"""Port parity: coordinates, quaternion helpers, DD formation, GNSS geometry,
the GNSS simulator and the trajectory CSVs.

The same numpy inputs go through ``glio_tpu`` and ``glio_tpu_torch`` on the
CPU. The JAX package computes its trig through ``safe_trig`` and the port
through plain torch, so f64 results agree to round-off, not bit for bit;
each test states its tolerance. Host numpy copies (master selection,
whitening, the simulator's slots and masks, CSV text) must be equal.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glio_tpu.data.simulator import simulate_gnss_epochs as jax_sim_gnss
from glio_tpu.eval import trajectory as jtraj
from glio_tpu.factors import gnss as jfg
from glio_tpu.gnss import converter as jconv
from glio_tpu.gnss import dd as jdd
from glio_tpu.utils import coords as jC
from glio_tpu.utils import quat as jquat
from glio_tpu_torch.data.simulator import drifted_trajectory
from glio_tpu_torch.data.simulator import simulate_gnss_epochs as port_sim_gnss
from glio_tpu_torch.eval import trajectory as ttraj
from glio_tpu_torch.factors import gnss as tfg
from glio_tpu_torch.gnss import dd as tdd
from glio_tpu_torch.utils import coords as tC
from glio_tpu_torch.utils import quat as tquat

ANCHOR = np.array([-2419233.42, 5385473.13, 2405341.30])
STATION = np.array([-2414266.92, 5386768.987, 2407460.031])
POS_TOL = 1e-8      # m, on ECEF coordinates of ~6.4e6 m (a few ulps)
ANG_TOL = 1e-14     # rad


def T(a):
    return torch.as_tensor(np.array(a, float))


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(0)
    enu = rng.uniform(-500.0, 500.0, size=(64, 3))
    return enu, np.asarray(jC.enu2ecef(jnp.asarray(enu), jnp.asarray(ANCHOR)))


def test_coords_round_trips_match_jax(points):
    enu, ecef_j = points
    ecef_t = tC.enu2ecef(T(enu), T(ANCHOR)).numpy()
    np.testing.assert_allclose(ecef_t, ecef_j, rtol=0, atol=POS_TOL)
    llh_j = np.asarray(jC.ecef2llh(jnp.asarray(ecef_j)))
    llh_t = tC.ecef2llh(T(ecef_j)).numpy()
    np.testing.assert_allclose(llh_t[:, :2], llh_j[:, :2], rtol=0, atol=ANG_TOL)
    np.testing.assert_allclose(llh_t[:, 2], llh_j[:, 2], rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(tC.llh2ecef(T(llh_j)).numpy(),
                               np.asarray(jC.llh2ecef(jnp.asarray(llh_j))),
                               rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(tC.ecef2enu(T(ecef_j), T(ANCHOR)).numpy(),
                               np.asarray(jC.ecef2enu(jnp.asarray(ecef_j), jnp.asarray(ANCHOR))),
                               rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(tC.ecef2enu_rotmat(T(llh_j)).numpy(),
                               np.asarray(jC.ecef2enu_rotmat(jnp.asarray(llh_j))),
                               rtol=0, atol=1e-15)
    # The round trip closes in the port itself.
    np.testing.assert_allclose(tC.ecef2enu(T(tC.enu2ecef_np(enu, ANCHOR)), T(ANCHOR)).numpy(),
                               enu, rtol=0, atol=1e-8)


def test_gps_time_and_azel_match_jax(points):
    t = np.array([1.6215e9, 1.6215e9 + 123.456, 315964800.0])
    week_j, tow_j = jC.unix2gpst(jnp.asarray(t))
    week_t, tow_t = tC.unix2gpst(t)
    np.testing.assert_array_equal(week_t, np.asarray(week_j))
    np.testing.assert_array_equal(tow_t, np.asarray(tow_j))
    _, ecef = points
    sats = ANCHOR + 2.2e7 * np.array([[0.3, 0.8, 0.5], [-0.2, 0.9, 0.4], [0.6, 0.2, 0.77]])
    az_j, el_j = jconv._azel_np(ecef[0], sats)
    az_t, el_t = tC.azel_np(ecef[0], sats)
    np.testing.assert_allclose(az_t, az_j, rtol=0, atol=ANG_TOL)
    np.testing.assert_allclose(el_t, el_j, rtol=0, atol=ANG_TOL)


def test_quat_helpers_match_jax():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(16, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    p = rng.normal(size=(16, 4))
    for name in ("qleft", "qright"):
        np.testing.assert_array_equal(getattr(tquat, name)(T(q)).numpy(),
                                      np.asarray(getattr(jquat, name)(jnp.asarray(q))))
    np.testing.assert_allclose((tquat.qleft(T(q)) @ T(p)[..., None])[..., 0].numpy(),
                               tquat.mul(T(q), T(p)).numpy(), rtol=0, atol=1e-15)
    ypr = rng.uniform(-1.5, 1.5, size=(16, 3))
    np.testing.assert_allclose(tquat.from_ypr(T(ypr)).numpy(),
                               np.asarray(jquat.from_ypr(jnp.asarray(ypr))), rtol=0, atol=1e-15)
    np.testing.assert_allclose(tquat.to_ypr(T(q)).numpy(),
                               np.asarray(jquat.to_ypr(jnp.asarray(q))), rtol=0, atol=1e-14)
    for t in (0.0, 0.3, 1.0):
        np.testing.assert_allclose(tquat.slerp_np(q[0], q[1], t),
                                   jquat.slerp_np(q[0], q[1], t), rtol=0, atol=0)
    np.testing.assert_allclose(tquat.slerp_np(q[0], q[0], 0.5), q[0], atol=1e-15)


@pytest.fixture(scope="module")
def epochs():
    kf_time, p_true, _, _ = drifted_trajectory(60)
    g_j = jax_sim_gnss(p_true, kf_time, ANCHOR, STATION, psr_noise=0.5, seed=4)
    g_t = port_sim_gnss(p_true, kf_time, ANCHOR, STATION, psr_noise=0.5, seed=4)
    return g_j, g_t


def test_simulate_gnss_epochs_matches_jax(epochs):
    """Slots, masks and masters equal; positions and ranges to round-off of
    the rover's ECEF (the JAX package's enu2ecef goes through safe_trig)."""
    g_j, g_t = epochs
    assert g_t.time.shape == (20,)
    for f in ("valid", "system", "master", "sat_id", "lli", "car_valid", "time", "snr"):
        np.testing.assert_array_equal(getattr(g_t, f), getattr(g_j, f), err_msg=f)
    for f in ("sat_pos", "sat_vel", "psr_rov", "psr_sta"):
        np.testing.assert_allclose(getattr(g_t, f), getattr(g_j, f), rtol=0, atol=1e-6,
                                   err_msg=f)
    np.testing.assert_allclose(g_t.elevation, g_j.elevation, rtol=0, atol=1e-12)
    np.testing.assert_allclose(g_t.dopp_rov, g_j.dopp_rov, rtol=0, atol=1e-9)
    assert g_t.valid.sum(axis=1).min() >= 8


def test_carrier_channel_matches_jax():
    kf_time, p_true, _, _ = drifted_trajectory(24)
    kw = dict(psr_noise=0.5, seed=2, carrier=True, slip_prob=0.2, amb_cycles_lambda=0.19)
    g_j = jax_sim_gnss(p_true, kf_time, ANCHOR, STATION, **kw)
    g_t = port_sim_gnss(p_true, kf_time, ANCHOR, STATION, **kw)
    np.testing.assert_array_equal(g_t.lli, g_j.lli)
    np.testing.assert_allclose(g_t.car_rov, g_j.car_rov, rtol=0, atol=1e-6)


def test_select_master_and_whitening_equal(epochs):
    g_j, _ = epochs
    for e in (0, 7, 19):
        m_t = tdd.select_master(g_j.elevation[e], g_j.valid[e], g_j.system[e])
        m_j = jdd.select_master(g_j.elevation[e], g_j.valid[e], g_j.system[e])
        np.testing.assert_array_equal(m_t, m_j)
        args = (g_j.elevation[e], g_j.snr[e], g_j.valid[e], g_j.system[e], m_j, 32)
        np.testing.assert_array_equal(tdd.dd_whitening_matrix(*args),
                                      jdd.dd_whitening_matrix(*args))
    np.testing.assert_array_equal(tdd.elesnr_var_np(g_j.elevation, g_j.snr),
                                  jdd.elesnr_var_np(g_j.elevation, g_j.snr))


@pytest.mark.parametrize("threshold", [1e9, 6.0])
def test_dd_residual_matches_jax(epochs, threshold):
    """One epoch at a time in JAX, all epochs at once in the port; the
    rover is put 3 m off so that some rows pass the threshold of 6."""
    g, _ = epochs
    rng = np.random.default_rng(3)
    whiten = np.stack([jdd.dd_whitening_matrix(g.elevation[e], g.snr[e], g.valid[e],
                                               g.system[e], g.master[e], 32)
                       for e in range(g.time.shape[0])])
    psr = g.psr_rov - (1e-3 * 299792458.0) + rng.normal(0, 3.0, size=g.psr_rov.shape)
    rov = np.asarray(jC.enu2ecef(jnp.asarray(rng.normal(0, 3.0, size=(g.time.shape[0], 3))),
                                 jnp.asarray(ANCHOR)))
    ref = np.stack([np.asarray(jdd.dd_residual(
        jnp.asarray(rov[e]), jnp.asarray(g.sat_pos[e]), jnp.asarray(psr[e]),
        jnp.asarray(g.psr_sta[e]), jnp.asarray(STATION), jnp.asarray(g.valid[e]),
        jnp.asarray(g.system[e]), jnp.asarray(g.master[e]), jnp.asarray(whiten[e]),
        threshold)) for e in range(g.time.shape[0])])
    got = tdd.dd_residual(T(rov), T(g.sat_pos), T(psr), T(g.psr_sta), T(STATION),
                          torch.as_tensor(g.valid), torch.as_tensor(g.system),
                          torch.as_tensor(g.master), T(whiten), threshold).numpy()
    assert got.shape == ref.shape == (20, 4, 32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-8)
    assert (np.abs(ref) > 0).sum() > 200


def test_r_ecef_local_matches_jax():
    for yaw in (0.0, 0.7, -2.1):
        R_j = np.asarray(jfg.r_ecef_local(jnp.asarray(ANCHOR), jnp.asarray(yaw)))
        R_t = tfg.r_ecef_local(T(ANCHOR), yaw).numpy()
        np.testing.assert_allclose(R_t, R_j, rtol=0, atol=1e-15)
        np.testing.assert_allclose(R_t @ R_t.T, np.eye(3), atol=1e-15)
        p = np.array([[10.0, -4.0, 2.0], [300.0, 120.0, -5.0]])
        np.testing.assert_allclose(
            tfg.local_to_ecef(T(p), T(ANCHOR), yaw).numpy(),
            np.asarray(jfg.local_to_ecef(jnp.asarray(p), jnp.asarray(ANCHOR), jnp.asarray(yaw))),
            rtol=0, atol=POS_TOL)


def test_result_csv_text_and_metrics_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    t = 1.6215e9 + np.arange(7) / 3.0
    llh = np.column_stack([np.deg2rad(22.3 + 1e-4 * rng.normal(size=7)),
                           np.deg2rad(114.19 + 1e-4 * rng.normal(size=7)),
                           rng.normal(size=7)])
    ypr = rng.normal(size=(7, 3))
    enu = rng.normal(size=(7, 3)) * 50
    jtraj.write_result_csv(str(tmp_path / "j.csv"), t, llh, ypr, enu)
    ttraj.write_result_csv(str(tmp_path / "t.csv"), t, llh, ypr, enu)
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    tr = ttraj.read_result_csv(str(tmp_path / "t.csv"))
    np.testing.assert_allclose(tr.enu, enu, atol=1e-8)
    np.testing.assert_allclose(tr.ecef, np.asarray(jtraj.read_result_csv(
        str(tmp_path / "j.csv")).ecef), rtol=0, atol=POS_TOL)
    ia_t, ib_t = ttraj.associate(t, t[::2] + 0.01, max_dt=0.05)
    ia_j, ib_j = jtraj.associate(t, t[::2] + 0.01, max_dt=0.05)
    np.testing.assert_array_equal(ia_t, ia_j)
    np.testing.assert_array_equal(ib_t, ib_j)
    assert ttraj.ate_rmse(enu, enu + 1.0)[0] == jtraj.ate_rmse(enu, enu + 1.0)[0]
    assert ttraj.rpe(enu, enu[::-1], 2)[0] == jtraj.rpe(enu, enu[::-1], 2)[0]
