"""RINEX observation / navigation file decoding, host numpy (a copy of ``glio_tpu/gnss/rinex.py``).

The offline converter's replacement for the RINEX machinery of the
reference's forked RTKLIB (stock 2.4.3 ``rinex.c``), written from the RINEX
3.03 spec: mixed GPS/BDS/GAL/GLO L1 observations (C/L/D/S), broadcast Kepler
ephemerides and GLONASS state vectors. Everything returns plain numpy; the
fixed-shape epochs are made in ``gnss.converter``. A copy, not an import:
importing ``glio_tpu`` imports jax. ``tests/test_torch_rinex.py`` holds every
function here to the original, bit for bit.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

# Constellation ids used throughout the framework.
SYS_GPS, SYS_GLO, SYS_GAL, SYS_BDS = 0, 1, 2, 3
SYS_CHAR = {"G": SYS_GPS, "R": SYS_GLO, "E": SYS_GAL, "C": SYS_BDS}

GPS_DAY0 = 44244  # MJD of 1980-01-06


def civil2mjd(y, m, d):
    """Gregorian calendar date → Modified Julian Day (integer)."""
    if m <= 2:
        y -= 1
        m += 12
    a = y // 100
    b = 2 - a + a // 4
    return int(365.25 * (y + 4716)) + int(30.6001 * (m + 1)) + d + b - 1524 - 2400001


def civil2gps(y, m, d, hh, mm, ss):
    """Civil date/time in GPS timescale → (week, tow)."""
    days = civil2mjd(y, m, d) - GPS_DAY0
    week = days // 7
    tow = (days % 7) * 86400.0 + hh * 3600.0 + mm * 60.0 + ss
    return week, tow


@dataclass
class Ephemeris:
    """Broadcast Kepler ephemeris (GPS / BDS / GAL)."""
    sys: int
    prn: int
    week: int          # GPS week of toe (BDS converted to GPS week)
    toe: float         # seconds of GPS week
    toc: float         # seconds of GPS week (clock reference)
    toes: float = 0.0  # toe seconds-of-week in the system's NATIVE timescale
                       # (BDT for BDS) — the ICD's −ω_e·toe term needs this
    af0: float = 0.0
    af1: float = 0.0
    af2: float = 0.0
    crs: float = 0.0
    delta_n: float = 0.0
    m0: float = 0.0
    cuc: float = 0.0
    e: float = 0.0
    cus: float = 0.0
    sqrt_a: float = 0.0
    cic: float = 0.0
    omega0: float = 0.0
    cis: float = 0.0
    i0: float = 0.0
    crc: float = 0.0
    omega: float = 0.0
    omega_dot: float = 0.0
    idot: float = 0.0
    tgd: float = 0.0
    sva: float = 0.0
    health: float = 0.0


@dataclass
class GloEphemeris:
    """GLONASS broadcast record: PZ-90 state vector + clock model.

    RINEX 3 'R' records carry position/velocity/acceleration (km) at the
    reference epoch plus −τ_n / γ_n; evaluation integrates the ICD motion
    model (RTKLIB ``geph2pos``/``deq``, ephemeris.c — behavior reference
    only)."""
    prn: int
    toe: float          # GPS unix seconds of the reference epoch
    tau_n: float        # −SV clock bias (s): dts = −τ_n + γ_n·(t−toe)
    gamma_n: float      # relative frequency bias
    pos: np.ndarray     # (3,) m, PZ-90 ECEF
    vel: np.ndarray     # (3,) m/s
    acc: np.ndarray     # (3,) m/s² (lunisolar perturbation)
    health: float = 0.0
    freq_num: int = 0   # FDMA channel k: f1 = 1602 MHz + k·562.5 kHz
    sys: int = SYS_GLO


GPS_UTC_LEAP_2021 = 18.0   # GPS − UTC leap seconds (2017-01-01 onward)

# GPS − UTC leap-second table keyed by the UTC date the offset took
# effect (IERS Bulletin C history; the reference gets this from RTKLIB's
# leaps[] table). Derive the offset from the record's own epoch so
# pre-2017 data (or data after a future leap second, once added here)
# converts correctly.
_LEAP_TABLE = (
    # (MJD of effectivity, GPS − UTC seconds)
    (civil2mjd(2017, 1, 1), 18.0),
    (civil2mjd(2015, 7, 1), 17.0),
    (civil2mjd(2012, 7, 1), 16.0),
    (civil2mjd(2009, 1, 1), 15.0),
    (civil2mjd(2006, 1, 1), 14.0),
    (civil2mjd(1999, 1, 1), 13.0),
    (civil2mjd(1997, 7, 1), 12.0),
    (civil2mjd(1996, 1, 1), 11.0),
    (civil2mjd(1994, 7, 1), 10.0),
    (civil2mjd(1993, 7, 1), 9.0),
    (civil2mjd(1992, 7, 1), 8.0),
    (civil2mjd(1991, 1, 1), 7.0),
    (civil2mjd(1990, 1, 1), 6.0),
    (civil2mjd(1988, 1, 1), 5.0),
    (civil2mjd(1985, 7, 1), 4.0),
    (civil2mjd(1983, 7, 1), 3.0),
    (civil2mjd(1982, 7, 1), 2.0),
    (civil2mjd(1981, 7, 1), 1.0),
)


def gps_utc_leap(y: int, m: int, d: int) -> float:
    """GPS − UTC leap-second offset in effect at a UTC civil date.

    Full table back to the GPS epoch (1980-01-06, GPS − UTC = 0); dates
    before the first leap second return 0.
    """
    mjd = civil2mjd(y, m, d)
    for mjd0, leap in _LEAP_TABLE:
        if mjd >= mjd0:
            return leap
    return 0.0


@dataclass
class ObsEpoch:
    time: float                        # GPS seconds (unix-referenced)
    sats: List[str]                    # e.g. "G14", "C11"
    psr: np.ndarray                    # (n,) pseudorange (m), nan if absent
    carrier: np.ndarray                # (n,) carrier phase (cycles)
    doppler: np.ndarray                # (n,) doppler (Hz)
    snr: np.ndarray                    # (n,) C/N0 (dB-Hz)
    lli: np.ndarray                    # (n,) loss-of-lock indicator


@dataclass
class ObsData:
    epochs: List[ObsEpoch] = field(default_factory=list)
    approx_pos: Optional[np.ndarray] = None


def _f(s: str) -> float:
    s = s.strip()
    if not s:
        return np.nan
    try:
        return float(s)
    except ValueError:
        return np.nan


def parse_obs(path: str, systems: str = "GREC") -> ObsData:
    """Parse a RINEX observation file (2.11 or 3.x, by header version).

    Keeps the first pseudorange/carrier/doppler/SNR observable per
    satellite (L1/B1/E1 codes come first in these files, matching the
    reference's L1-only processing, ``gnss_preprocessor.cpp:79`` nf=1).
    Version dispatch mirrors RTKLIB, which decodes both in one reader
    (``rinex.c:632-735`` handles the v2 epoch/observation layout) — the
    reference's launch names a v2.11 CORS base file
    (``GLIO/launch/run_urban_hk.launch:32``, ``hksc1410.21o``).
    """
    with open(path) as fh:
        first = fh.readline()
    version = 3.0
    if first[60:].strip().startswith("RINEX VERSION"):
        v = _f(first[0:9])
        if np.isfinite(v):
            version = v
    if version < 3.0:
        return _parse_obs_v2(path, systems)
    return _parse_obs_v3(path, systems)


def _parse_obs_v3(path: str, systems: str) -> ObsData:
    obs_types: Dict[str, List[str]] = {}
    out = ObsData()
    with open(path) as fh:
        # ---- header ----
        for line in fh:
            label = line[60:].strip()
            if label == "SYS / # / OBS TYPES":
                sys_c = line[0]
                n = int(line[3:6])
                types = line[7:60].split()
                while len(types) < n:
                    cont = next(fh)
                    types += cont[7:60].split()
                obs_types[sys_c] = types
            elif label == "APPROX POSITION XYZ":
                out.approx_pos = np.array(
                    [_f(line[0:14]), _f(line[14:28]), _f(line[28:42])])
            elif label == "END OF HEADER":
                break

        # Column picks per system: first C*, L*, D*, S* observables.
        picks = {}
        for sys_c, types in obs_types.items():
            def first(prefix):
                for i, t in enumerate(types):
                    if t.startswith(prefix):
                        return i
                return None
            picks[sys_c] = (first("C"), first("L"), first("D"), first("S"))

        # ---- body ----
        for line in fh:
            if not line.startswith(">"):
                continue
            y = int(line[2:6]); mo = int(line[7:9]); dd = int(line[10:12])
            hh = int(line[13:15]); mi = int(line[16:18]); ss = float(line[18:29])
            flag = int(line[31:32])
            nsat = int(line[32:35])
            week, tow = civil2gps(y, mo, dd, hh, mi, ss)
            t = 315964800.0 + week * 604800.0 + tow
            sats, psr, car, dop, snr, lli = [], [], [], [], [], []
            for _ in range(nsat):
                rec = next(fh, "").rstrip("\n")
                sat = rec[0:3].replace(" ", "0")
                sys_c = sat[0]
                if sys_c not in picks or sys_c not in systems:
                    continue
                pc, pl, pd, ps = picks[sys_c]

                def val(col):
                    if col is None:
                        return np.nan, 0
                    start = 3 + 16 * col
                    fld = rec[start:start + 14]
                    l = rec[start + 14:start + 15].strip()
                    return _f(fld), int(l) if l else 0

                p, _ = val(pc)
                c, li = val(pl)
                d, _ = val(pd)
                s, _ = val(ps)
                if np.isnan(p):
                    continue
                sats.append(sat)
                psr.append(p); car.append(c); dop.append(d)
                snr.append(s); lli.append(li)
            # Flags 0 AND 1 are valid observation epochs (flag 1 = power
            # failure between the previous and current epoch — the data
            # itself is good; RTKLIB decodes both).
            if flag in (0, 1) and sats:
                out.epochs.append(ObsEpoch(
                    time=t, sats=sats,
                    psr=np.array(psr), carrier=np.array(car),
                    doppler=np.array(dop), snr=np.array(snr),
                    lli=np.array(lli)))
    return out


def _parse_obs_v2(path: str, systems: str) -> ObsData:
    """RINEX 2.11 observation body (the CORS base-station format).

    v2 differences from v3 (RINEX 2.11 spec §5; RTKLIB ``rinex.c:632-735``
    behavior reference): one global ``# / TYPES OF OBSERV`` list (9 types
    per 6-char-field line with continuations), 2-digit years, epoch lines
    carrying the satellite list inline (12 per line, continuations), and
    per-satellite observation rows of 5×16-char fields with continuation
    lines when more than 5 observables are defined. A blank system char in
    a satellite id means GPS.
    """
    out = ObsData()
    types: List[str] = []
    with open(path) as fh:
        # ---- header ----
        n_types = 0
        for line in fh:
            label = line[60:].strip()
            if label == "# / TYPES OF OBSERV":
                if line[0:6].strip():
                    n_types = int(line[0:6])
                for k in range(9):
                    t = line[6 + 6 * k: 12 + 6 * k].strip()
                    if t:
                        types.append(t)
            elif label == "APPROX POSITION XYZ":
                out.approx_pos = np.array(
                    [_f(line[0:14]), _f(line[14:28]), _f(line[28:42])])
            elif label == "END OF HEADER":
                break
        types = types[:n_types] if n_types else types

        # Column picks: v2 codes pseudorange as C1 (C/A) or P1 (P-code).
        def first(prefixes):
            for pre in prefixes:
                for i, t in enumerate(types):
                    if t == pre:
                        return i
            return None

        pc = first(("C1", "P1"))
        pl = first(("L1",))
        pd = first(("D1",))
        ps = first(("S1",))
        n_obs_lines = max(1, -(-len(types) // 5))

        # ---- body ----
        for line in fh:
            # The loop only lands on epoch lines (observation rows are
            # consumed by the inner next() calls); skip anything that
            # doesn't carry the I3 flag + I3 satellite-count fields.
            if len(line) < 32:
                continue
            try:
                flag = int(line[26:29])
                nsat = int(line[29:32])
            except ValueError:
                continue
            if flag > 1:
                # Event records: skip the following nsat header-like lines.
                for _ in range(nsat):
                    next(fh, None)
                continue
            try:
                yy = int(line[1:3])
                mo = int(line[4:6])
                dd = int(line[7:9])
                hh = int(line[10:12])
                mi = int(line[13:15])
                ss = float(line[16:26])
            except ValueError:
                continue
            y = 1900 + yy if yy >= 80 else 2000 + yy
            week, tow = civil2gps(y, mo, dd, hh, mi, ss)
            t = 315964800.0 + week * 604800.0 + tow

            sat_ids = []
            cur = line
            read = 0
            while read < nsat:
                k = read % 12
                if read and k == 0:
                    # Graceful on truncated files: a missing continuation
                    # line degrades to blank satellite ids (whose rows
                    # then parse as NaN and are dropped) instead of
                    # raising StopIteration out of the generator.
                    cur = next(fh, "")
                fld = cur[32 + 3 * k: 35 + 3 * k].ljust(3)
                sys_c = fld[0]
                if sys_c == " ":
                    sys_c = "G"
                sat_ids.append(sys_c + fld[1:3].replace(" ", "0"))
                read += 1

            sats, psr, car, dop, snr, lli = [], [], [], [], [], []
            for sat in sat_ids:
                fields = []
                for _ in range(n_obs_lines):
                    rec = next(fh, "").rstrip("\n")
                    for k in range(5):
                        if len(fields) >= len(types):
                            break
                        fld = rec[16 * k: 16 * k + 14]
                        li = rec[16 * k + 14: 16 * k + 15].strip()
                        fields.append((_f(fld), int(li) if li else 0))
                if sat[0] not in SYS_CHAR or sat[0] not in systems:
                    continue

                def val(col):
                    if col is None or col >= len(fields):
                        return np.nan, 0
                    return fields[col]

                p, _unused = val(pc)
                c, li_ = val(pl)
                d, _unused = val(pd)
                s, _unused = val(ps)
                if np.isnan(p):
                    continue
                sats.append(sat)
                psr.append(p); car.append(c); dop.append(d)
                snr.append(s); lli.append(li_)
            # Flags 0 AND 1 are valid observation epochs (flag 1 = power
            # failure between the previous and current epoch — the data
            # itself is good; RTKLIB decodes both).
            if flag in (0, 1) and sats:
                out.epochs.append(ObsEpoch(
                    time=t, sats=sats,
                    psr=np.array(psr), carrier=np.array(car),
                    doppler=np.array(dop), snr=np.array(snr),
                    lli=np.array(lli)))
    return out


def write_obs_v2(obs: ObsData, path: str, n_epochs: Optional[int] = None):
    """Write observations as RINEX 2.11 (C1/L1/D1/S1).

    Interop/test helper: round-tripping a decoded v3 file through this
    writer and ``parse_obs`` reproduces identical epochs, which exercises
    the v2 decode path.
    """
    epochs = obs.epochs[:n_epochs] if n_epochs else obs.epochs
    with open(path, "w") as fh:
        fh.write(f"{2.11:9.2f}{'':11s}{'OBSERVATION DATA':<20s}"
                 f"{'M (MIXED)':<20s}RINEX VERSION / TYPE\n")
        if obs.approx_pos is not None:
            fh.write(f"{obs.approx_pos[0]:14.4f}{obs.approx_pos[1]:14.4f}"
                     f"{obs.approx_pos[2]:14.4f}{'':18s}"
                     "APPROX POSITION XYZ\n")
        fh.write(f"{4:6d}    C1    L1    D1    S1{'':30s}"
                 "# / TYPES OF OBSERV\n")
        fh.write(f"{'':60s}END OF HEADER\n")
        for ep in epochs:
            tu = ep.time - 315964800.0
            week = int(tu // 604800.0)
            tow = tu - week * 604800.0
            mjd = GPS_DAY0 + week * 7 + int(tow // 86400.0)
            sod = tow - int(tow // 86400.0) * 86400.0
            # MJD → civil (inverse of civil2mjd).
            a = mjd + 2400001 + 32044
            b = (4 * a + 3) // 146097
            c = a - 146097 * b // 4
            d = (4 * c + 3) // 1461
            e = c - 1461 * d // 4
            m = (5 * e + 2) // 153
            day = e - (153 * m + 2) // 5 + 1
            month = m + 3 - 12 * (m // 10)
            year = 100 * b + d - 4800 + m // 10
            hh = int(sod // 3600)
            mi = int((sod - hh * 3600) // 60)
            ss = sod - hh * 3600 - mi * 60
            fh.write(f" {year % 100:02d} {month:2d} {day:2d} {hh:2d} "
                     f"{mi:2d}{ss:11.7f}  0{len(ep.sats):3d}")
            for j, sat in enumerate(ep.sats):
                if j and j % 12 == 0:
                    fh.write("\n" + " " * 32)
                fh.write(sat)
            fh.write("\n")
            for j in range(len(ep.sats)):
                for v, li in ((ep.psr[j], 0), (ep.carrier[j], ep.lli[j]),
                              (ep.doppler[j], 0), (ep.snr[j], 0)):
                    if np.isnan(v):
                        fh.write(" " * 16)
                    else:
                        fh.write(f"{v:14.3f}{int(li) or ' '}"[:15] + " ")
                fh.write("\n")


# BDT week 0 began at GPS week 1356; BDT = GPST − 14 s.
BDS_WEEK_OFFSET = 1356
BDS_TIME_OFFSET = 14.0


def parse_nav(path: str, glo: Optional[Dict[str, List[GloEphemeris]]] = None,
              skip_kepler: bool = False) -> Dict[str, List[Ephemeris]]:
    """Parse a RINEX 3 navigation file → {sat: [Ephemeris sorted by toe]}.

    GPS/GAL/BDS Kepler records. GLONASS state-vector records are decoded
    into `glo` when a dict is passed (``parse_nav_glo`` wraps this); with
    glo=None they are skipped (the UrbanNav launch runs GPS+BDS L1).
    """
    out: Dict[str, List[Ephemeris]] = {}
    with open(path) as fh:
        for line in fh:
            if line[60:].strip() == "END OF HEADER":
                break
        lines = fh.readlines()

    def fnum(s):
        return _f(s.replace("D", "E").replace("d", "e"))

    i = 0
    while i < len(lines):
        line = lines[i]
        sat = line[0:3].replace(" ", "0")
        sys_c = sat[0]
        if sys_c == "R":           # GLONASS: 4-line state-vector records
            if glo is None:
                i += 4
                continue
            try:
                y = int(line[4:8]); mo = int(line[9:11]); dd = int(line[12:14])
                hh = int(line[15:17]); mi = int(line[18:20]); ss = int(line[21:23])
            except ValueError:
                i += 1
                continue
            vals = [fnum(line[23 + 19 * k: 23 + 19 * (k + 1)])
                    for k in range(3)]
            rows = []
            for k in range(3):
                l2 = lines[i + 1 + k]
                rows.append([fnum(l2[4 + 19 * j: 4 + 19 * (j + 1)])
                             for j in range(4)])
            i += 4
            # Epoch is UTC; GLONASS clock applies at UTC(SU) — convert the
            # record epoch to the GPS timescale used throughout, with the
            # leap-second offset in effect at the record's own date.
            week, tow = civil2gps(y, mo, dd, hh, mi, ss)
            toe = 315964800.0 + week * 604800.0 + tow + gps_utc_leap(
                y, mo, dd)
            geph = GloEphemeris(
                prn=int(sat[1:3]), toe=toe,
                tau_n=-vals[0], gamma_n=vals[1],
                pos=np.array([rows[0][0], rows[1][0], rows[2][0]]) * 1e3,
                vel=np.array([rows[0][1], rows[1][1], rows[2][1]]) * 1e3,
                acc=np.array([rows[0][2], rows[1][2], rows[2][2]]) * 1e3,
                health=rows[0][3], freq_num=int(rows[1][3]))
            glo.setdefault(sat, []).append(geph)
            continue
        if sys_c not in ("G", "C", "E"):
            i += 1
            continue
        if skip_kepler:          # GLONASS-only pass (parse_nav_glo)
            i += 8
            continue
        try:
            y = int(line[4:8]); mo = int(line[9:11]); dd = int(line[12:14])
            hh = int(line[15:17]); mi = int(line[18:20]); ss = int(line[21:23])
        except ValueError:
            i += 1
            continue
        vals = [fnum(line[23 + 19 * k: 23 + 19 * (k + 1)]) for k in range(3)]
        body = []
        for k in range(7):
            l2 = lines[i + 1 + k]
            body += [fnum(l2[4 + 19 * j: 4 + 19 * (j + 1)]) for j in range(4)]
        i += 8

        # body[] layout (7 data lines × 4 fields):
        #  0:IODE 1:Crs 2:Δn 3:M0 | 4:Cuc 5:e 6:Cus 7:√A |
        #  8:Toe 9:Cic 10:Ω0 11:Cis | 12:i0 13:Crc 14:ω 15:Ω̇ |
        # 16:IDOT 17:codes 18:week 19:flag | 20:sva 21:health 22:TGD 23:IODC
        week_field = body[18]      # GPS week (GPS/GAL) or BDT week (BDS)
        toe = body[8]
        toes = body[8]             # native-timescale seconds of week
        toc_week, toc_tow = civil2gps(y, mo, dd, hh, mi, ss)
        if sys_c == "C":
            # Times in the file are BDT; convert to GPS timescale.
            week = int(week_field) + BDS_WEEK_OFFSET
            toe = toe + BDS_TIME_OFFSET
            toc_tow = toc_tow  # toc date is already given in BDT civil time
            # Convert the civil toc (BDT) to GPS by adding the 14 s offset.
            toc_tow += BDS_TIME_OFFSET
            # Guard week rollover from the +14 s.
            if toc_tow >= 604800.0:
                toc_tow -= 604800.0
                toc_week += 1
        else:
            week = int(week_field)
        eph = Ephemeris(
            sys=SYS_CHAR[sys_c], prn=int(sat[1:3]), week=week, toe=toe,
            toes=toes,
            toc=toc_week * 604800.0 + toc_tow - week * 604800.0,
            af0=vals[0], af1=vals[1], af2=vals[2],
            crs=body[1], delta_n=body[2], m0=body[3],
            cuc=body[4], e=body[5], cus=body[6], sqrt_a=body[7],
            cic=body[9], omega0=body[10], cis=body[11],
            i0=body[12], crc=body[13], omega=body[14], omega_dot=body[15],
            idot=body[16], sva=body[20], health=body[21], tgd=body[22],
        )
        out.setdefault(sat, []).append(eph)

    for sat in out:
        out[sat].sort(key=lambda e: e.week * 604800.0 + e.toe)
    return out


def parse_nav_glo(path: str) -> Dict[str, List[GloEphemeris]]:
    """GLONASS records of a RINEX 3 nav file → {sat: [GloEphemeris]}."""
    glo: Dict[str, List[GloEphemeris]] = {}
    parse_nav(path, glo=glo, skip_kepler=True)
    for sat in glo:
        glo[sat].sort(key=lambda e: e.toe)
    return glo


def select_geph(gephs: List[GloEphemeris], t_gps: float,
                max_age: float = 1800.0) -> Optional[GloEphemeris]:
    """Nearest healthy GLONASS record within the 30-min fit interval."""
    best, best_dt = None, np.inf
    for e in gephs:
        if e.health != 0:
            continue
        dt = abs(t_gps - e.toe)
        if dt < best_dt:
            best, best_dt = e, dt
    return best if best is not None and best_dt <= max_age else None


def select_eph(ephs: List[Ephemeris], t_gps: float) -> Optional[Ephemeris]:
    """Pick the ephemeris whose toe is nearest to t (within fit interval)."""
    best, best_dt = None, np.inf
    for e in ephs:
        dt = abs(t_gps - (315964800.0 + e.week * 604800.0 + e.toe))
        if dt < best_dt:
            best, best_dt = e, dt
    max_age = 3700.0 * 2 if (best and best.sys == SYS_BDS) else 7200.0 * 2
    if best is not None and best_dt > max_age:
        return None
    return best
