"""Broadcast ephemeris → satellite position / velocity / clock (a copy of ``glio_tpu/gnss/ephemeris.py``).

Fresh implementation of Kepler broadcast ephemeris evaluation per the
GPS/BDS/GAL ICDs, replacing the role of RTKLIB's ``eph2pos``/``satposs``
(``RTKLIB/src/ephemeris.c`` — behavior reference only).  Covers:

* GPS / Galileo / BeiDou MEO+IGSO, and the BDS GEO special rotation,
* SV clock bias with relativistic correction (and TGD for pseudorange use),
* velocity via central differencing (same approach as RTKLIB),
* signal transmission-time iteration from the observed pseudorange.

Numpy, host-side: satellite states are baked into the epochs by the
converter, so none of this runs on the device. ``tests/test_torch_rinex.py``
holds it to the JAX package's copy bit for bit.
"""

import numpy as np

from .rinex import Ephemeris, SYS_BDS, SYS_GAL

CLIGHT = 299792458.0
MU_GPS = 3.9860050e14
MU_GAL = 3.986004418e14
MU_BDS = 3.986004418e14
OMGE_GPS = 7.2921151467e-5
OMGE_BDS = 7.292115e-5

GPS_UNIX_EPOCH = 315964800.0


def _mu_omge(sys):
    if sys == SYS_BDS:
        return MU_BDS, OMGE_BDS
    if sys == SYS_GAL:
        return MU_GAL, OMGE_GPS
    return MU_GPS, OMGE_GPS


def eph_time(e: Ephemeris) -> float:
    return GPS_UNIX_EPOCH + e.week * 604800.0 + e.toe


def sat_clock(e: Ephemeris, t_gps: float, iters: int = 2) -> float:
    """SV clock bias (s) at GPS time, polynomial part only (no TGD)."""
    toc = GPS_UNIX_EPOCH + e.week * 604800.0 + e.toc
    dt = t_gps - toc
    for _ in range(iters):
        dt = t_gps - toc - (e.af0 + e.af1 * dt + e.af2 * dt * dt)
    return e.af0 + e.af1 * dt + e.af2 * dt * dt


def sat_pos(e: Ephemeris, t_gps: float):
    """ECEF position (m) + relativistic clock correction (s) at GPS time.

    BDS GEO satellites (PRN ≤ 5 or ≥ 59) use the −5° inclined-frame
    rotation from the BDS ICD.
    """
    mu, omge = _mu_omge(e.sys)
    tk = t_gps - eph_time(e)

    A = e.sqrt_a ** 2
    n = np.sqrt(mu / A ** 3) + e.delta_n
    M = e.m0 + n * tk
    E = M
    for _ in range(30):
        E_new = M + e.e * np.sin(E)
        if abs(E_new - E) < 1e-13:
            E = E_new
            break
        E = E_new

    sinE, cosE = np.sin(E), np.cos(E)
    nu = np.arctan2(np.sqrt(1.0 - e.e ** 2) * sinE, cosE - e.e)
    phi = nu + e.omega
    s2p, c2p = np.sin(2 * phi), np.cos(2 * phi)
    du = e.cus * s2p + e.cuc * c2p
    dr = e.crs * s2p + e.crc * c2p
    di = e.cis * s2p + e.cic * c2p
    u = phi + du
    r = A * (1.0 - e.e * cosE) + dr
    i = e.i0 + di + e.idot * tk
    x_op = r * np.cos(u)
    y_op = r * np.sin(u)

    geo = e.sys == SYS_BDS and (e.prn <= 5 or e.prn >= 59)
    if not geo:
        # −ω_e·toe uses the NATIVE (BDT for BeiDou) seconds-of-week: the
        # +14 s BDT→GPS shift here would rotate the constellation by
        # ω_e·14 s ≈ 1 mrad ≈ 6.5 km on the ground.
        Omega = e.omega0 + (e.omega_dot - omge) * tk - omge * e.toes
        sO, cO = np.sin(Omega), np.cos(Omega)
        si, ci = np.sin(i), np.cos(i)
        pos = np.array([
            x_op * cO - y_op * ci * sO,
            x_op * sO + y_op * ci * cO,
            y_op * si,
        ])
    else:
        # BDS GEO: orbital plane computed without earth-rotation coupling,
        # then rotated by −5° about X and ω_e·tk about Z (BDS ICD 5.2.4.12).
        Omega = e.omega0 + e.omega_dot * tk - omge * e.toes
        sO, cO = np.sin(Omega), np.cos(Omega)
        si, ci = np.sin(i), np.cos(i)
        xg = np.array([
            x_op * cO - y_op * ci * sO,
            x_op * sO + y_op * ci * cO,
            y_op * si,
        ])
        a5 = np.deg2rad(-5.0)
        Rx = np.array([[1, 0, 0],
                       [0, np.cos(a5), np.sin(a5)],
                       [0, -np.sin(a5), np.cos(a5)]])
        ang = omge * tk
        Rz = np.array([[np.cos(ang), np.sin(ang), 0],
                       [-np.sin(ang), np.cos(ang), 0],
                       [0, 0, 1]])
        pos = Rz @ Rx @ xg

    rel = -2.0 * np.sqrt(mu * A) * e.e * sinE / CLIGHT ** 2
    return pos, rel


def sat_pos_vel_clock(e: Ephemeris, t_gps: float, dt: float = 1e-3):
    """(pos, vel, clock_bias, clock_drift) at GPS time t.

    Velocity/drift by central differencing (RTKLIB ``ephemeris.c`` uses the
    same trick with a 1 ms step).
    """
    p0, rel0 = sat_pos(e, t_gps - dt)
    p1, rel1 = sat_pos(e, t_gps + dt)
    pos, rel = sat_pos(e, t_gps)
    vel = (p1 - p0) / (2 * dt)
    clk = sat_clock(e, t_gps) + rel
    clk0 = sat_clock(e, t_gps - dt) + rel0
    clk1 = sat_clock(e, t_gps + dt) + rel1
    ddt = (clk1 - clk0) / (2 * dt)
    return pos, vel, clk, ddt


def tx_time_sat_state(e: Ephemeris, t_rx_gps: float, psr: float):
    """Satellite state at signal transmission time.

    Standard iteration: t_tx = t_rx − P/c − dt_sv (RTKLIB ``satposs``).
    Returns (pos, vel, clk, ddt) in the ECEF frame of transmission time
    (earth-rotation/Sagnac handled downstream, as in the reference).
    """
    t_tx = t_rx_gps - psr / CLIGHT
    for _ in range(2):
        dts = sat_clock(e, t_tx)
        t_tx = t_rx_gps - psr / CLIGHT - dts
    return sat_pos_vel_clock(e, t_tx)


# --- GLONASS state-vector ephemeris ------------------------------------------

MU_GLO = 3.9860044e14
J2_GLO = 1.0826257e-3
RE_GLO = 6378136.0
OMGE_GLO = 7.292115e-5


def _glo_deriv(x, acc):
    """PZ-90 equations of motion: central body + J2 + earth rotation +
    lunisolar acceleration from the broadcast record (GLONASS ICD 5.2;
    same model RTKLIB's ``deq`` integrates)."""
    p, v = x[:3], x[3:]
    r2 = p @ p
    r = np.sqrt(r2)
    a = -MU_GLO / (r2 * r)
    b = 1.5 * J2_GLO * MU_GLO * RE_GLO ** 2 / (r2 * r2 * r)
    z2r2 = 5.0 * p[2] ** 2 / r2
    om2 = OMGE_GLO ** 2
    # The J2 oblateness term SUBTRACTS from the central attraction in the
    # xy plane and carries an extra −2b·z on the pole axis (ICD:
    # ẍ = (−μ/r³ − b(1−5z²/r²))x + ω²x + 2ωẏ + ax, etc.).
    dv = np.array([
        (a - b * (1.0 - z2r2)) * p[0] + om2 * p[0]
        + 2.0 * OMGE_GLO * v[1] + acc[0],
        (a - b * (1.0 - z2r2)) * p[1] + om2 * p[1]
        - 2.0 * OMGE_GLO * v[0] + acc[1],
        (a - b * (3.0 - z2r2)) * p[2] + acc[2],
    ])
    return np.concatenate([v, dv])


def _glo_integrate(x, t_span: float, acc, step: float = 60.0):
    """RK4-integrate a PZ-90 state over t_span seconds (≤`step` steps)."""
    sgn = 1.0 if t_span >= 0 else -1.0
    remaining = abs(t_span)
    while remaining > 1e-9:
        h = sgn * min(step, remaining)
        k1 = _glo_deriv(x, acc)
        k2 = _glo_deriv(x + k1 * h / 2, acc)
        k3 = _glo_deriv(x + k2 * h / 2, acc)
        k4 = _glo_deriv(x + k3 * h, acc)
        x = x + (k1 + 2 * k2 + 2 * k3 + k4) * h / 6.0
        remaining -= abs(h)
    return x


def glo_pos_vel(geph, t_gps: float, step: float = 60.0):
    """Integrate the GLONASS state vector to t (RK4, ≤60 s steps)."""
    x = _glo_integrate(np.concatenate([geph.pos, geph.vel]),
                       t_gps - geph.toe, geph.acc, step)
    return x[:3], x[3:]


def glo_clock(geph, t_gps: float) -> float:
    """SV clock bias (s): −τ_n + γ_n·(t − toe) (GLONASS ICD)."""
    dt = t_gps - geph.toe
    return -geph.tau_n + geph.gamma_n * dt


def glo_tx_state(geph, t_rx_gps: float, psr: float):
    """Transmission-time state for a GLONASS satellite
    (pos, vel, clk, ddt) — the GLONASS twin of ``tx_time_sat_state``."""
    t_tx = t_rx_gps - psr / CLIGHT
    for _ in range(2):
        t_tx = t_rx_gps - psr / CLIGHT - glo_clock(geph, t_tx)
    pos, vel = glo_pos_vel(geph, t_tx)
    return pos, vel, glo_clock(geph, t_tx), geph.gamma_n


def glo_tx_state_chain(geph, t_rx, psr):
    """Transmission-time states for MANY epochs sharing one record.

    The converter calls this per (satellite, record) group: the state is
    integrated INCREMENTALLY between the time-sorted epochs (≈1 s hops)
    instead of from toe for every epoch — ~30× fewer RK4 steps over a
    30-min record window.
    Returns (pos (n,3), vel (n,3), clk (n,), ddt (n,)).
    """
    t_rx = np.asarray(t_rx, float)
    psr = np.asarray(psr, float)
    n = len(t_rx)
    pos = np.zeros((n, 3))
    vel = np.zeros((n, 3))
    clk = np.zeros(n)
    ddt = np.zeros(n)
    order = np.argsort(t_rx, kind="stable")
    t_cur = geph.toe
    x = np.concatenate([geph.pos, geph.vel])
    for j in order:
        t_tx = t_rx[j] - psr[j] / CLIGHT
        for _ in range(2):
            t_tx = t_rx[j] - psr[j] / CLIGHT - glo_clock(geph, t_tx)
        x = _glo_integrate(x, t_tx - t_cur, geph.acc)
        t_cur = t_tx
        pos[j], vel[j] = x[:3], x[3:]
        clk[j] = glo_clock(geph, t_tx)
        ddt[j] = geph.gamma_n
    return pos, vel, clk, ddt


# --- Vectorized batch evaluation (converter hot path) ------------------------

_EPH_FIELDS = ("sys", "prn", "week", "toe", "toc", "toes", "af0", "af1",
               "af2", "crs", "delta_n", "m0", "cuc", "e", "cus", "sqrt_a",
               "cic", "omega0", "cis", "i0", "crc", "omega", "omega_dot",
               "idot", "tgd")


def stack_ephs(ephs):
    """List[Ephemeris] → dict of (N,) numpy arrays for batch evaluation."""
    return {f: np.array([getattr(e, f) for e in ephs], float)
            for f in _EPH_FIELDS}


def _sat_pos_batch(P, t_gps):
    """Vectorized ``sat_pos`` over parameter arrays (N,) at times (N,)."""
    is_bds = P["sys"] == SYS_BDS
    mu = np.where(is_bds, MU_BDS,
                  np.where(P["sys"] == SYS_GAL, MU_GAL, MU_GPS))
    omge = np.where(is_bds, OMGE_BDS, OMGE_GPS)
    eph_t = GPS_UNIX_EPOCH + P["week"] * 604800.0 + P["toe"]
    tk = t_gps - eph_t

    A = P["sqrt_a"] ** 2
    n = np.sqrt(mu / A ** 3) + P["delta_n"]
    M = P["m0"] + n * tk
    ecc = P["e"]
    E = M.copy()
    for _ in range(12):
        E = M + ecc * np.sin(E)
    sinE, cosE = np.sin(E), np.cos(E)
    nu = np.arctan2(np.sqrt(1.0 - ecc ** 2) * sinE, cosE - ecc)
    phi = nu + P["omega"]
    s2p, c2p = np.sin(2 * phi), np.cos(2 * phi)
    u = phi + P["cus"] * s2p + P["cuc"] * c2p
    r = A * (1.0 - ecc * cosE) + P["crs"] * s2p + P["crc"] * c2p
    i = P["i0"] + P["cis"] * s2p + P["cic"] * c2p + P["idot"] * tk
    x_op, y_op = r * np.cos(u), r * np.sin(u)

    geo = is_bds & ((P["prn"] <= 5) | (P["prn"] >= 59))
    om_dot_eff = np.where(geo, P["omega_dot"], P["omega_dot"] - omge)
    Omega = P["omega0"] + om_dot_eff * tk - omge * P["toes"]
    sO, cO = np.sin(Omega), np.cos(Omega)
    si, ci = np.sin(i), np.cos(i)
    x = x_op * cO - y_op * ci * sO
    y = x_op * sO + y_op * ci * cO
    z = y_op * si

    # BDS GEO frame rotation.
    a5 = np.deg2rad(-5.0)
    c5, s5 = np.cos(a5), np.sin(a5)
    yg = c5 * y + s5 * z
    zg = -s5 * y + c5 * z
    ang = omge * tk
    ca, sa = np.cos(ang), np.sin(ang)
    xr = ca * x + sa * yg
    yr = -sa * x + ca * yg
    x = np.where(geo, xr, x)
    y = np.where(geo, yr, y)
    z = np.where(geo, zg, z)

    rel = -2.0 * np.sqrt(mu * A) * ecc * sinE / CLIGHT ** 2
    return np.stack([x, y, z], -1), rel


def _sat_clock_batch(P, t_gps):
    toc = GPS_UNIX_EPOCH + P["week"] * 604800.0 + P["toc"]
    dt = t_gps - toc
    for _ in range(2):
        dt = t_gps - toc - (P["af0"] + P["af1"] * dt + P["af2"] * dt * dt)
    return P["af0"] + P["af1"] * dt + P["af2"] * dt * dt


def tx_state_batch(P, t_rx, psr, dt: float = 1e-3):
    """Vectorized transmission-time satellite states.

    Args: P = stacked eph params (N,), t_rx (N,) GPS unix seconds,
    psr (N,) observed pseudoranges.
    Returns (pos (N,3), vel (N,3), clk (N,), ddt (N,)).
    """
    t_tx = t_rx - psr / CLIGHT
    for _ in range(2):
        t_tx = t_rx - psr / CLIGHT - _sat_clock_batch(P, t_tx)
    p0, rel0 = _sat_pos_batch(P, t_tx - dt)
    p1, rel1 = _sat_pos_batch(P, t_tx + dt)
    pos, rel = _sat_pos_batch(P, t_tx)
    vel = (p1 - p0) / (2 * dt)
    clk = _sat_clock_batch(P, t_tx) + rel
    clk0 = _sat_clock_batch(P, t_tx - dt) + rel0
    clk1 = _sat_clock_batch(P, t_tx + dt) + rel1
    ddt = (clk1 - clk0) / (2 * dt)
    return pos, vel, clk, ddt
