"""ctypes bindings for the native RINEX decoder (a copy of ``glio_tpu/gnss/native.py``).

The decoder is host code: ``native/rinex_fast.cpp`` at the root of the
checkout, compiled by ``g++ -O2 -shared -fPIC -std=c++17`` at first use into
``build/glio_tpu_torch/`` under a name that carries a hash of the source and
the flags (as ``ops/_build.py`` builds the CUDA sources), so an edited source
is rebuilt and an unchanged one is loaded as it is. ``available()`` is False
only where there is no ``g++``; then ``gnss.converter.convert`` takes the
Python parser, as the JAX package does without its library. A build that
fails raises with the compiler's output.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from .rinex import (BDS_TIME_OFFSET, BDS_WEEK_OFFSET, Ephemeris, GloEphemeris,
                    ObsData, ObsEpoch, SYS_CHAR, civil2gps, gps_utc_leap)

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "rinex_fast.cpp"
BUILD_DIR = ROOT / "build" / "glio_tpu_torch"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_LIB = None


def library_path() -> Path:
    text = SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
    return BUILD_DIR / f"librinex_fast_{hashlib.sha256(text).hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the decoder unless a library of the same hash exists."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native RINEX decoder cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE.name} (exit {res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stderr}{res.stdout}")
    os.replace(tmp, out)
    return out


def available() -> bool:
    """True when the library is built or can be: there is a ``g++``."""
    return _LIB is not None or library_path().exists() or shutil.which("g++") is not None


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    lib.rinex_obs_open.restype = ctypes.c_void_p
    lib.rinex_obs_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.rinex_obs_num_epochs.restype = ctypes.c_long
    lib.rinex_obs_num_epochs.argtypes = [ctypes.c_void_p]
    lib.rinex_obs_num_records.restype = ctypes.c_long
    lib.rinex_obs_num_records.argtypes = [ctypes.c_void_p]
    lib.rinex_obs_approx.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.rinex_obs_epochs.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 2
    lib.rinex_obs_records.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 8
    lib.rinex_obs_close.argtypes = [ctypes.c_void_p]
    lib.rinex_nav_open.restype = ctypes.c_void_p
    lib.rinex_nav_open.argtypes = [ctypes.c_char_p]
    lib.rinex_nav_count.restype = ctypes.c_long
    lib.rinex_nav_count.argtypes = [ctypes.c_void_p]
    lib.rinex_nav_records.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 5
    lib.rinex_nav_close.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def parse_obs_native(path: str, systems: str = "GREC") -> ObsData:
    """Native-decode a RINEX 3 obs file into the same ObsData structure."""
    lib = _load()
    h = lib.rinex_obs_open(path.encode(), systems.encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        ne = lib.rinex_obs_num_epochs(h)
        nr = lib.rinex_obs_num_records(h)
        week = np.zeros(ne)
        tow = np.zeros(ne)
        lib.rinex_obs_epochs(h, week.ctypes.data, tow.ctypes.data)
        epoch = np.zeros(nr, np.int32)
        sysc = np.zeros(nr, np.int8)
        prn = np.zeros(nr, np.int32)
        psr = np.zeros(nr)
        car = np.zeros(nr)
        dop = np.zeros(nr)
        snr = np.zeros(nr)
        lli = np.zeros(nr, np.int32)
        lib.rinex_obs_records(
            h, epoch.ctypes.data, sysc.ctypes.data, prn.ctypes.data,
            psr.ctypes.data, car.ctypes.data, dop.ctypes.data,
            snr.ctypes.data, lli.ctypes.data)
        approx = np.zeros(3)
        has_approx = lib.rinex_obs_approx(h, approx.ctypes.data)
    finally:
        lib.rinex_obs_close(h)

    t = 315964800.0 + week * 604800.0 + tow
    out = ObsData(approx_pos=approx if has_approx else None)
    order = np.argsort(epoch, kind="stable")
    epoch_s = epoch[order]
    bounds = np.searchsorted(epoch_s, np.arange(ne + 1))
    for k in range(ne):
        lo, hi = bounds[k], bounds[k + 1]
        if lo == hi:
            continue
        idx = order[lo:hi]
        sats = [f"{chr(sysc[i])}{prn[i]:02d}" for i in idx]
        out.epochs.append(ObsEpoch(
            time=float(t[k]), sats=sats, psr=psr[idx], carrier=car[idx],
            doppler=dop[idx], snr=snr[idx], lli=lli[idx]))
    return out


def _nav_records(path: str):
    lib = _load()
    h = lib.rinex_nav_open(path.encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        n = lib.rinex_nav_count(h)
        sysc = np.zeros(n, np.int8)
        prn = np.zeros(n, np.int32)
        toc = np.zeros((n, 6), np.int32)
        clock = np.zeros((n, 3))
        body = np.zeros((n, 28))
        lib.rinex_nav_records(h, sysc.ctypes.data, prn.ctypes.data,
                              toc.ctypes.data, clock.ctypes.data,
                              body.ctypes.data)
    finally:
        lib.rinex_nav_close(h)
    return n, sysc, prn, toc, clock, body


def parse_nav_native(path: str):
    """Native-decode a RINEX 3 nav file → same dict as rinex.parse_nav."""
    n, sysc, prn, toc, clock, body = _nav_records(path)
    out = {}
    for i in range(n):
        sys_c = chr(sysc[i])
        if sys_c == "R":       # GLONASS → parse_nav_glo_native
            continue
        b = body[i]
        toe = b[8]
        toes = b[8]
        toc_week, toc_tow = civil2gps(*toc[i])
        if sys_c == "C":
            week = int(b[18]) + BDS_WEEK_OFFSET
            toe = toe + BDS_TIME_OFFSET
            toc_tow += BDS_TIME_OFFSET
            if toc_tow >= 604800.0:
                toc_tow -= 604800.0
                toc_week += 1
        else:
            week = int(b[18])
        e = Ephemeris(
            sys=SYS_CHAR[sys_c], prn=int(prn[i]), week=week, toe=toe,
            toc=toc_week * 604800.0 + toc_tow - week * 604800.0, toes=toes,
            af0=clock[i][0], af1=clock[i][1], af2=clock[i][2],
            crs=b[1], delta_n=b[2], m0=b[3],
            cuc=b[4], e=b[5], cus=b[6], sqrt_a=b[7],
            cic=b[9], omega0=b[10], cis=b[11],
            i0=b[12], crc=b[13], omega=b[14], omega_dot=b[15],
            idot=b[16], sva=b[20], health=b[21], tgd=b[22])
        out.setdefault(f"{sys_c}{prn[i]:02d}", []).append(e)
    for sat in out:
        out[sat].sort(key=lambda e: e.week * 604800.0 + e.toe)
    return out


def parse_nav_glo_native(path: str):
    """Native-decode the GLONASS 'R' records of a RINEX 3 nav file →
    same {sat: [GloEphemeris]} as ``rinex.parse_nav_glo`` (4-line
    state-vector records; body[0..11] = x/vx/ax/health, y/vy/ay/freq#,
    z/vz/az/age in km; UTC epoch → GPS with the date's leap seconds)."""
    n, sysc, prn, toc, clock, body = _nav_records(path)
    glo = {}
    for i in range(n):
        if chr(sysc[i]) != "R":
            continue
        b = body[i]
        y, mo, dd = int(toc[i][0]), int(toc[i][1]), int(toc[i][2])
        week, tow = civil2gps(*toc[i])
        toe = (315964800.0 + week * 604800.0 + tow
               + gps_utc_leap(y, mo, dd))
        sat = f"R{prn[i]:02d}"
        glo.setdefault(sat, []).append(GloEphemeris(
            prn=int(prn[i]), toe=toe,
            tau_n=-clock[i][0], gamma_n=clock[i][1],
            pos=np.array([b[0], b[4], b[8]]) * 1e3,
            vel=np.array([b[1], b[5], b[9]]) * 1e3,
            acc=np.array([b[2], b[6], b[10]]) * 1e3,
            health=b[3], freq_num=int(b[7])))
    for sat in glo:
        glo[sat].sort(key=lambda e: e.toe)
    return glo
