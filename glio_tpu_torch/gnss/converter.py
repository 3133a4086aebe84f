"""Offline converter: RINEX files → fixed-shape GNSS epochs (port of ``glio_tpu/gnss/converter.py``).

The reference's GNSS stack (``gnss_preprocessor_node`` + a forked RTKLIB)
becomes one pass over the RINEX set, on the host: the epochs are flattened
into (epoch, satellite) records with their ephemeris picks, every
satellite state is evaluated in one vectorized batch
(``ephemeris.tx_state_batch``, GLONASS by its RK4 chain), the elevation and
C/N0 masks and the Klobuchar / Saastamoinen corrections are applied, and the
records are scattered into ``max_sv`` slots per epoch with a master per
constellation. The result is the port's ``GnssEpochs``, numpy on the host,
as ``simulate_gnss_epochs`` makes it.

Station handling: without a base-station RINEX, ``synthesize_station=True``
builds exact station observations from the known station ECEF (config
``station_x_/y_/z_``): geometric range + Sagnac − c·dt_sv + TGD + iono +
tropo, what double differencing assumes of a noise-free base receiver.

Differences from the JAX package: ``utils.coords`` replaces
``glio_tpu.utils.coords`` (the geodetic conversions in torch f64 on the CPU,
with the library's sin and cos where the JAX package has its ``safe_trig``),
so az/el and the values derived from them (iono, tropo, the corrected and
synthesized pseudoranges) agree at round-off; everything else is the same
numpy.
"""

import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..data.episode import GnssEpochs
from ..utils import coords as C
from . import atmosphere, dd
from .ephemeris import CLIGHT, glo_tx_state_chain, stack_ephs, tx_state_batch
from .rinex import (SYS_BDS, SYS_CHAR, SYS_GLO, parse_nav, parse_nav_glo, parse_obs,
                    select_eph, select_geph)

FREQ_L1 = 1.57542e9
FREQ_B1 = 1.561098e9
FREQ_E1 = 1.57542e9
FREQ_G1 = 1.60200e9
LAMBDA = {0: CLIGHT / FREQ_L1, 1: CLIGHT / FREQ_G1,
          2: CLIGHT / FREQ_E1, 3: CLIGHT / FREQ_B1}


@dataclass
class ConvertOptions:
    max_sv: int = 32
    elevation_mask_deg: float = 15.0   # gnss_preprocessor.cpp:83 / pntpos
    snr_mask: float = 15.0
    systems: str = "GC"                # UrbanNav u-blox GC files
    synthesize_station: bool = True
    max_epochs: Optional[int] = None


def _read(rover_obs_path, nav_path, opts: ConvertOptions):
    """The native decoder where g++ is, the Python parser otherwise."""
    from . import native as native_mod
    if native_mod.available():
        obs = native_mod.parse_obs_native(rover_obs_path, opts.systems)
        nav = native_mod.parse_nav_native(nav_path)
        glo_nav = native_mod.parse_nav_glo_native(nav_path) if "R" in opts.systems else {}
    else:
        obs = parse_obs(rover_obs_path, systems=opts.systems)
        nav = parse_nav(nav_path)
        glo_nav = parse_nav_glo(nav_path) if "R" in opts.systems else {}
    if opts.max_epochs:
        obs.epochs = obs.epochs[: opts.max_epochs]
    return obs, nav, glo_nav


def convert(rover_obs_path: str, nav_path: str, station_ecef,
            station_obs_path: Optional[str] = None,
            opts: ConvertOptions = ConvertOptions(),
            timings: Optional[dict] = None) -> GnssEpochs:
    """Decode, correct and tensorize a GNSS sequence. With ``timings`` (a
    dict), the seconds of the decode ("decode") and of the rest
    ("convert") are stored there."""
    t0 = time.perf_counter()
    obs, nav, glo_nav = _read(rover_obs_path, nav_path, opts)
    sta_by_time: Dict[float, dict] = {}
    if station_obs_path:
        for ep in parse_obs(station_obs_path, systems=opts.systems).epochs:
            sta_by_time[round(ep.time, 2)] = dict(zip(ep.sats, ep.psr))
    t1 = time.perf_counter()

    station_ecef = np.asarray(station_ecef, float)
    approx = obs.approx_pos
    if approx is None or np.linalg.norm(approx) < 1e6:
        # A missing or zero APPROX POSITION header: the base station gives
        # the geometry of the elevations and the atmosphere.
        approx = station_ecef

    # ---- pass 1: flatten (epoch, sat) records with ephemeris picks ----
    ep_idx, ephs, psr, dopp, snr, sats = [], [], [], [], [], []
    car, lli = [], []
    t_rx = []
    gephs = []       # per-record GloEphemeris (None for Kepler rows)
    for k, ep in enumerate(obs.epochs):
        for j, sat in enumerate(ep.sats):
            geph = None
            if sat[0] == "R":
                geph = select_geph(glo_nav.get(sat, []), ep.time)
                if geph is None:
                    continue
            else:
                cand = nav.get(sat)
                if not cand:
                    continue
                e = select_eph(cand, ep.time)
                if e is None or e.health != 0:
                    continue
                ephs.append(e)
            ep_idx.append(k)
            gephs.append(geph)
            psr.append(ep.psr[j])
            dopp.append(ep.doppler[j])
            snr.append(ep.snr[j])
            car.append(ep.carrier[j])
            lli.append(int(ep.lli[j]))
            sats.append(sat)
            t_rx.append(ep.time)

    ep_idx = np.array(ep_idx, np.int64)
    psr = np.array(psr)
    dopp = np.array(dopp)
    snr = np.array(snr)
    car = np.array(car)
    lli = np.array(lli, np.int8)
    t_rx = np.array(t_rx)
    sysid = np.array([SYS_CHAR[s[0]] for s in sats], np.int8)
    prn = np.array([int(s[1:]) for s in sats], np.int32)
    is_glo = sysid == SYS_GLO

    # ---- batch satellite states (Kepler batch + GLONASS integration) ----
    n_rec = len(sats)
    pos = np.zeros((n_rec, 3))
    vel = np.zeros((n_rec, 3))
    clk = np.zeros(n_rec)
    ddt = np.zeros(n_rec)
    tgd = np.zeros(n_rec)
    kep = ~is_glo
    if kep.any():
        P = stack_ephs(ephs)
        pos[kep], vel[kep], clk[kep], ddt[kep] = tx_state_batch(P, t_rx[kep], psr[kep])
        tgd[kep] = P["tgd"] * CLIGHT
    # One incremental RK4 walk per broadcast record.
    glo_groups = {}
    for r in np.nonzero(is_glo)[0]:
        glo_groups.setdefault(id(gephs[r]), (gephs[r], []))[1].append(r)
    for geph, rows in glo_groups.values():
        rows = np.asarray(rows)
        pos[rows], vel[rows], clk[rows], ddt[rows] = glo_tx_state_chain(
            geph, t_rx[rows], psr[rows])

    # ---- geometry + masks ----
    az, el = C.azel_np(approx, pos)
    keep = (el > np.deg2rad(opts.elevation_mask_deg)) & (snr >= opts.snr_mask)

    # ---- atmosphere (rover + station) ----
    rcv_llh = C.ecef2llh_np(approx)
    sta_llh = C.ecef2llh_np(station_ecef)
    _, tow = C.unix2gpst(t_rx)
    iono = atmosphere.klobuchar(tow, rcv_llh[0], rcv_llh[1], az, el)
    # Per-record carrier frequency: GLONASS is FDMA (f = 1602 MHz +
    # k·562.5 kHz per channel k from the broadcast record).
    freq = np.full(n_rec, FREQ_L1)
    freq[sysid == SYS_BDS] = FREQ_B1
    for r in np.nonzero(is_glo)[0]:
        freq[r] = 1.602e9 + gephs[r].freq_num * 562.5e3
    f_scale = (FREQ_L1 / freq) ** 2
    iono = iono * f_scale
    tropo = atmosphere.saastamoinen(rcv_llh[0], rcv_llh[2], el)

    az_s, el_s = C.azel_np(station_ecef, pos)
    iono_s = atmosphere.klobuchar(tow, sta_llh[0], sta_llh[1], az_s, el_s) * f_scale
    tropo_s = atmosphere.saastamoinen(sta_llh[0], sta_llh[2], el_s)
    rho_s = np.linalg.norm(pos - station_ecef, axis=-1)
    # The Sagnac term a physical receiver measures: without it the double
    # differences keep the rover's whole, satellite-dependent term.
    OMGE = 7.2921151467e-5
    sagnac_s = OMGE / CLIGHT * (pos[:, 0] * station_ecef[1]
                                - pos[:, 1] * station_ecef[0])
    psr_sta_synth = rho_s + sagnac_s - clk * CLIGHT + tgd + iono_s + tropo_s
    # Station carrier phase: geometric + clock + tropo − iono (phase
    # advance), no group delay and no ambiguity.
    car_sta_synth = rho_s + sagnac_s - clk * CLIGHT + tropo_s - iono_s

    # ---- scatter into fixed-shape epoch tensors ----
    E = len(obs.epochs)
    M = opts.max_sv
    g = GnssEpochs(
        time=np.array([ep.time for ep in obs.epochs]),
        sat_pos=np.zeros((E, M, 3)), sat_vel=np.zeros((E, M, 3)),
        sat_ddt=np.zeros((E, M)),
        psr_rov=np.zeros((E, M)), psr_sta=np.zeros((E, M)),
        psr_rov_corr=np.zeros((E, M)), dopp_rov=np.zeros((E, M)),
        elevation=np.zeros((E, M)), snr=np.zeros((E, M)),
        valid=np.zeros((E, M), bool),
        system=np.zeros((E, M), np.int8),
        master=np.full((E, 4), -1, np.int32),
        car_rov=np.zeros((E, M)),
        car_sta=np.zeros((E, M)),
        car_valid=np.zeros((E, M), bool),
        lli=np.zeros((E, M), np.int8),
        sat_id=np.full((E, M), -1, np.int32),
        station_synthesized=np.asarray(opts.synthesize_station and not station_obs_path),
    )
    slot_used = np.zeros(E, np.int32)
    lam = CLIGHT / freq
    psr_corr = psr + clk * CLIGHT - tgd - iono - tropo

    for r in range(len(ep_idx)):
        if not keep[r]:
            continue
        k = int(ep_idx[r])
        s = slot_used[k]
        if s >= M:
            continue
        slot_used[k] = s + 1
        g.sat_pos[k, s] = pos[r]
        g.sat_vel[k, s] = vel[r]
        g.sat_ddt[k, s] = ddt[r] * CLIGHT
        g.psr_rov[k, s] = psr[r]
        g.psr_rov_corr[k, s] = psr_corr[r]
        g.dopp_rov[k, s] = -dopp[r] * lam[r]
        g.elevation[k, s] = el[r]
        g.snr[k, s] = snr[r]
        g.system[k, s] = sysid[r]
        g.sat_id[k, s] = int(sysid[r]) * 100 + prn[r]
        g.lli[k, s] = lli[r]
        has_car = np.isfinite(car[r]) and car[r] != 0.0
        if has_car:
            g.car_rov[k, s] = car[r] * lam[r]
            g.car_sta[k, s] = car_sta_synth[r]
            g.car_valid[k, s] = True
        sta_real = sta_by_time.get(round(t_rx[r], 2)) if sta_by_time else None
        if sta_real is not None and sats[r] in sta_real:
            g.psr_sta[k, s] = sta_real[sats[r]]
            g.valid[k, s] = True
        elif opts.synthesize_station:
            g.psr_sta[k, s] = psr_sta_synth[r]
            g.valid[k, s] = True
        else:
            g.psr_sta[k, s] = np.nan
            g.valid[k, s] = True

    for k in range(E):
        g.master[k] = dd.select_master(g.elevation[k], g.valid[k], g.system[k])
    if timings is not None:
        timings["decode"] = t1 - t0
        timings["convert"] = time.perf_counter() - t1
    return g
