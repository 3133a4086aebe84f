"""Port parity: RINEX input (``gnss/rinex.py``, ``gnss/ephemeris.py``,
``gnss/atmosphere.py``, ``gnss/native.py``, ``gnss/converter.py``).

The files are the port's own (``testing.write_synthetic_rinex``): 60 epochs
at 1 Hz along the batch drive's first 180 keyframes, 8 GPS and 6 BDS
satellites (one BDS GEO), the UrbanNav u-blox "GC" layout. The JAX package
reads them through the same code paths as recorded files.

The decoders, the ephemerides, the atmosphere models and the leap-second
table are numpy copies: equal to the JAX package's bit for bit. ``convert``
agrees in its slots, masks, masters and satellite ids exactly, and in every
float that does not pass through the geodetic conversions bit for bit;
the values that do (elevation; the corrected and synthesized pseudoranges,
through the iono and tropo) within 1e-14 rad and 1e-8 m, the JAX package's
``safe_trig`` against the library's sin and cos (as in
``tests/test_torch_gnss.py``).
"""

import dataclasses

import numpy as np
import pytest

from glio_tpu.gnss import atmosphere as j_atm
from glio_tpu.gnss import converter as j_conv
from glio_tpu.gnss import ephemeris as j_eph
from glio_tpu.gnss import native as j_native
from glio_tpu.gnss import rinex as j_rinex
from glio_tpu_torch import testing
from glio_tpu_torch.config import GlioConfig
from glio_tpu_torch.gnss import atmosphere as t_atm
from glio_tpu_torch.gnss import converter as t_conv
from glio_tpu_torch.gnss import ephemeris as t_eph
from glio_tpu_torch.gnss import native as t_native
from glio_tpu_torch.gnss import rinex as t_rinex

STATION = np.asarray(GlioConfig().initialization.station_ecef)
SC = dict(testing.GNSS_DRIVE, n_keyframes=180)

# A GLONASS record (RINEX 3: epoch in UTC, −τ_n, γ_n, t_k; then x/vx/ax/health,
# y/vy/ay/freq#, z/vz/az/age in km), at the drive's hour.
GLO_RECORD = """R07 2021 05 17 01 59 42-2.123415470123E-05 9.094947017729E-13 5.400000000000E+03
     1.207348486328E+04-2.155431747437E+00 9.313225746155E-10 0.000000000000E+00
     1.928024462891E+04 9.766473770142E-01 0.000000000000E+00 5.000000000000E+00
     8.627436523438E+03 2.771148681641E+00-1.862645149231E-09 0.000000000000E+00
"""


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("rinex")
    kf, p_true, _, _, t_gps, rover = testing.gnss_drive(SC)
    obs, nav = str(d / "drive.obs"), str(d / "drive.nav")
    info = testing.write_synthetic_rinex(obs, nav, t_gps, rover, seed=SC["seed"],
                                         n_gps=SC["n_gps"], n_bds=SC["n_bds"])
    nav_glo = str(d / "glo.nav")
    with open(nav) as fh, open(nav_glo, "w") as out:
        out.write(fh.read() + GLO_RECORD)
    return dict(obs=obs, nav=nav, nav_glo=nav_glo, dir=d, t_gps=t_gps, rover=rover, info=info)


def _same_obs(a, b):
    assert len(a.epochs) == len(b.epochs) > 0
    np.testing.assert_array_equal(a.approx_pos, b.approx_pos)
    for ea, eb in zip(a.epochs, b.epochs):
        assert ea.time == eb.time and ea.sats == eb.sats
        for f in ("psr", "carrier", "doppler", "snr", "lli"):
            np.testing.assert_array_equal(getattr(ea, f), getattr(eb, f), err_msg=f)


def _same_nav(a, b):
    assert sorted(a) == sorted(b)
    for sat in a:
        assert [dataclasses.asdict(e) for e in a[sat]] == [dataclasses.asdict(e) for e in b[sat]]


def test_writer_drive(files):
    """At least 8 satellites above the 15° mask at every epoch, a BDS GEO
    (PRN ≤ 5) and BDS MEOs, C/L/D/S for each."""
    obs = t_rinex.parse_obs(files["obs"], systems="GC")
    assert len(obs.epochs) == 60
    assert files["info"]["sats"][8:10] == ["C01", "C11"]
    g = t_conv.convert(files["obs"], files["nav"], STATION)
    assert g.valid.sum(1).min() >= 8
    assert (g.sat_id == 301).any() and (g.sat_id == 311).any()
    assert np.isfinite(g.dopp_rov[g.valid]).all() and (g.dopp_rov[g.valid] != 0).all()
    assert g.car_valid[g.valid].all() and (g.snr[g.valid] > 15).all()


@pytest.mark.parametrize("systems", ["GC", "G", "C"])
def test_parse_obs_v3_matches_jax(files, systems):
    _same_obs(t_rinex.parse_obs(files["obs"], systems), j_rinex.parse_obs(files["obs"], systems))


def test_parse_obs_v2_matches_jax(files):
    """v2.11 through ``write_obs_v2``: the two writers make the same text,
    and both v2 decoders read back the v3 file's epochs."""
    v3 = t_rinex.parse_obs(files["obs"], systems="GC")
    pt, pj = str(files["dir"] / "port.o"), str(files["dir"] / "jax.o")
    t_rinex.write_obs_v2(v3, pt, n_epochs=20)
    j_rinex.write_obs_v2(v3, pj, n_epochs=20)
    with open(pt) as a, open(pj) as b:
        assert a.read() == b.read()
    back_t = t_rinex.parse_obs(pt, systems="GC")
    _same_obs(back_t, j_rinex.parse_obs(pj, systems="GC"))
    for ea, eb in zip(back_t.epochs, v3.epochs[:20]):
        assert ea.sats == eb.sats
        np.testing.assert_array_equal(ea.psr, eb.psr)


def test_parse_nav_and_select_eph_match_jax(files):
    nav_t, nav_j = t_rinex.parse_nav(files["nav"]), j_rinex.parse_nav(files["nav"])
    _same_nav(nav_t, nav_j)
    assert nav_t["C01"][0].toes == nav_t["C01"][0].toe - t_rinex.BDS_TIME_OFFSET
    for t in files["t_gps"][::7]:
        for sat in nav_t:
            a, b = t_rinex.select_eph(nav_t[sat], t), j_rinex.select_eph(nav_j[sat], t)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert t_rinex.select_eph(nav_t["G01"], files["t_gps"][0] + 30000.0) is None


def test_tx_state_batch_matches_jax(files):
    """GPS, BDS MEO and the BDS GEO frame, bit for bit."""
    nav = t_rinex.parse_nav(files["nav"])
    ephs = [nav[s][0] for s in sorted(nav)] * 5
    t = np.repeat(files["t_gps"][::12], len(nav))
    psr = 2.1e7 + 1e5 * np.arange(t.shape[0]) / t.shape[0]
    out_t = t_eph.tx_state_batch(t_eph.stack_ephs(ephs), t, psr)
    out_j = j_eph.tx_state_batch(j_eph.stack_ephs(ephs), t, psr)
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a, b)
    geo = np.array([e.sys == t_rinex.SYS_BDS and e.prn <= 5 for e in ephs])
    r = np.linalg.norm(out_t[0], axis=-1)
    assert geo.any() and (r[geo] > 4.1e7).all() and (r[~geo] < 2.9e7).all()


def test_atmosphere_matches_jax():
    rng = np.random.default_rng(3)
    az = rng.uniform(-np.pi, np.pi, 200)
    el = rng.uniform(0.0, np.pi / 2, 200)
    tow = rng.uniform(0, 604800.0, 200)
    np.testing.assert_array_equal(t_atm.klobuchar(tow, 0.39, 1.99, az, el),
                                  j_atm.klobuchar(tow, 0.39, 1.99, az, el))
    for h in (-50.0, 30.0, 12000.0):
        np.testing.assert_array_equal(t_atm.saastamoinen(0.39, h, el),
                                      j_atm.saastamoinen(0.39, h, el))


def test_gps_utc_leap_matches_jax():
    for date in ((1980, 6, 1), (1985, 7, 1), (1999, 1, 1), (2012, 6, 30), (2016, 12, 31),
                 (2017, 1, 1), (2021, 5, 17)):
        assert t_rinex.gps_utc_leap(*date) == j_rinex.gps_utc_leap(*date)
        assert t_rinex.civil2gps(*date, 3, 4, 5.5) == j_rinex.civil2gps(*date, 3, 4, 5.5)


def test_glonass_record_matches_jax(files):
    """``parse_nav_glo`` (UTC epoch + the date's leap seconds), the native
    decoder's GLONASS path and the RK4 chain ``glo_tx_state_chain``."""
    glo_t = t_rinex.parse_nav_glo(files["nav_glo"])
    glo_j = j_rinex.parse_nav_glo(files["nav_glo"])
    assert sorted(glo_t) == sorted(glo_j) == ["R07"]
    a, b = glo_t["R07"][0], glo_j["R07"][0]
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))
    assert a.toe == testing.gps_unix(2021, 5, 17, 1, 59, 42) + 18.0 and a.freq_num == 5
    nat = t_native.parse_nav_glo_native(files["nav_glo"])["R07"][0]
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(nat, f.name), getattr(a, f.name))
    # Kepler records are untouched by the GLONASS record.
    _same_nav(t_rinex.parse_nav(files["nav_glo"]), t_rinex.parse_nav(files["nav"]))
    t_rx = a.toe + np.array([30.0, 1.0, 2.0, 600.0, 601.0])
    psr = np.full(5, 2.2e7)
    out_t = t_eph.glo_tx_state_chain(a, t_rx, psr)
    out_j = j_eph.glo_tx_state_chain(b, t_rx, psr)
    for x, y in zip(out_t, out_j):
        np.testing.assert_array_equal(x, y)
    r = np.linalg.norm(out_t[0], axis=-1)
    assert ((r > 2.3e7) & (r < 2.7e7)).all()
    sel = t_rinex.select_geph(glo_t["R07"], a.toe + 100.0)
    assert sel is a and t_rinex.select_geph(glo_t["R07"], a.toe + 4000.0) is None


def test_native_matches_python(files):
    """The decoder built from ``native/rinex_fast.cpp`` into the port's
    build directory reads what the Python parser reads."""
    assert t_native.available()
    assert t_native.build().parent == t_native.BUILD_DIR
    _same_obs(t_native.parse_obs_native(files["obs"], "GC"),
              t_rinex.parse_obs(files["obs"], systems="GC"))
    _same_nav(t_native.parse_nav_native(files["nav"]), t_rinex.parse_nav(files["nav"]))


def test_native_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(t_native, "SOURCE", bad)
    monkeypatch.setattr(t_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on broken.cpp"):
        t_native.build()


FLOAT_EXACT = ("time", "sat_pos", "sat_vel", "sat_ddt", "psr_rov", "dopp_rov", "snr",
               "car_rov")
INT_EXACT = ("valid", "system", "master", "car_valid", "lli", "sat_id", "station_synthesized")
ROUND_OFF = {"elevation": 1e-14, "psr_rov_corr": 1e-8, "psr_sta": 1e-8, "car_sta": 1e-8}


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_convert_matches_jax(files, native, monkeypatch):
    assert j_native.available() and t_native.available()   # JAX's: tests/conftest.py
    if not native:
        monkeypatch.setattr(j_native, "available", lambda: False)
        monkeypatch.setattr(t_native, "available", lambda: False)
    g_t = t_conv.convert(files["obs"], files["nav"], STATION)
    g_j = j_conv.convert(files["obs"], files["nav"], STATION)
    assert sorted(f.name for f in dataclasses.fields(g_t)) == \
        sorted(f.name for f in dataclasses.fields(g_j))
    for f in FLOAT_EXACT + INT_EXACT:
        np.testing.assert_array_equal(getattr(g_t, f), getattr(g_j, f), err_msg=f)
        assert np.asarray(getattr(g_t, f)).dtype == np.asarray(getattr(g_j, f)).dtype, f
    for f, tol in ROUND_OFF.items():
        np.testing.assert_allclose(getattr(g_t, f), getattr(g_j, f), rtol=0, atol=tol,
                                   err_msg=f)
    assert g_t.valid.sum() > 60 * 8


def test_convert_timings_and_options(files):
    tm = {}
    g = t_conv.convert(files["obs"], files["nav"], STATION, timings=tm,
                       opts=t_conv.ConvertOptions(max_epochs=10, systems="G",
                                                  elevation_mask_deg=30.0))
    assert set(tm) == {"decode", "convert"} and g.time.shape == (10,)
    assert (g.system[g.valid] == 0).all() and (g.elevation[g.valid] > np.deg2rad(30.0)).all()
    assert (g.master[:, 3] == -1).all()
