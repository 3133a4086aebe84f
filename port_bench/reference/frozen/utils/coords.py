"""Geodetic coordinate and GPS-time conversions, WGS-84 (port of ``glio_tpu/utils/coords.py``).

The torch functions broadcast over leading axes and keep the input's dtype
and device; the port calls them in f64. ``*_np`` are numpy twins for host
code (the GNSS simulator, CSV output): they run the same torch code on CPU
tensors, so there is one implementation of each formula. ``safe_trig``, a
workaround for one XLA build's scalar f64 trig, has no counterpart.
"""

import numpy as np
import torch

# WGS-84 constants (RTKLIB rtklib.h / gnss_utility.cpp).
RE_WGS84 = 6378137.0            # earth semimajor axis (m)
FE_WGS84 = 1.0 / 298.257223563  # earth flattening
CLIGHT = 299792458.0            # speed of light (m/s)
OMGE = 7.2921151467e-5          # earth angular velocity (rad/s)

GPS_SECS_PER_WEEK = 604800.0
# GPS time epoch 1980-01-06 00:00:00 UTC as unix seconds.
GPS_UNIX_EPOCH = 315964800.0

_E2 = FE_WGS84 * (2.0 - FE_WGS84)


def ecef2llh(xyz, iters: int = 6):
    """ECEF → geodetic [lat, lon, height] by a fixed number of latitude
    iterations (``ecef2geo``'s scheme)."""
    x, y, z = xyz.unbind(-1)
    r = torch.sqrt(x * x + y * y)
    lon = torch.atan2(y, x)
    lat = torch.atan2(z, r * (1.0 - _E2))
    v = torch.full_like(lat, RE_WGS84)
    for _ in range(iters):
        sl = torch.sin(lat)
        v = RE_WGS84 / torch.sqrt(1.0 - _E2 * sl * sl)
        lat = torch.atan2(z + v * _E2 * sl, r)
    h = r / torch.cos(lat) - v
    h = torch.where(r < 1e-3, torch.abs(z) - RE_WGS84 * np.sqrt(1.0 - _E2), h)
    return torch.stack([lat, lon, h], dim=-1)


def ecef2enu_rotmat(ref_llh):
    """Rotation taking ECEF deltas to local ENU at ``ref_llh``:
    enu = R @ (ecef − ref)."""
    lat, lon = ref_llh[..., 0], ref_llh[..., 1]
    sl, cl = torch.sin(lat), torch.cos(lat)
    so, co = torch.sin(lon), torch.cos(lon)
    m = torch.stack([
        -so, co, torch.zeros_like(so),
        -sl * co, -sl * so, cl,
        cl * co, cl * so, sl,
    ], dim=-1)
    return m.reshape(ref_llh.shape[:-1] + (3, 3))


def enu2ecef(enu, ref_ecef):
    R = ecef2enu_rotmat(ecef2llh(ref_ecef))
    return ref_ecef + torch.einsum("...ji,...j->...i", R, enu)


# --- numpy twins for host code ------------------------------------------------

def _np(fn, *arrays):
    return fn(*(torch.as_tensor(np.array(a, float)) for a in arrays)).numpy()


def ecef2llh_np(xyz):
    return _np(ecef2llh, xyz)


def ecef2enu_rotmat_np(ref_llh):
    return _np(ecef2enu_rotmat, ref_llh)


def enu2ecef_np(enu, ref_ecef):
    return _np(enu2ecef, enu, ref_ecef)


def azel_np(rcv_ecef, sat_pos):
    """Azimuth and elevation (rad) of satellites (M, 3) seen from one
    receiver (3,), both ECEF (``gnss/converter.py::_azel_np``)."""
    rcv = np.asarray(rcv_ecef, float)
    R = ecef2enu_rotmat_np(ecef2llh_np(rcv))
    enu = (np.asarray(sat_pos, float) - rcv) @ R.T
    az = np.arctan2(enu[:, 0], enu[:, 1])
    el = np.arctan2(enu[:, 2], np.linalg.norm(enu[:, :2], axis=-1))
    return az, el
