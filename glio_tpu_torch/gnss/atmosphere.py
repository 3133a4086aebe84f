"""Ionosphere / troposphere delay models, numpy (a copy of ``glio_tpu/gnss/atmosphere.py``).

Replaces the correction models RTKLIB applies when building the corrected
pseudorange it publishes (``pntpos.cpp:668-780``: broadcast Klobuchar iono
+ Saastamoinen tropo, per the options set in ``gnss_preprocessor.cpp:74-89``).
Implemented from the GPS ICD / Saastamoinen model directly.
"""

import numpy as np

CLIGHT = 299792458.0

# Default Klobuchar coefficients (RTKLIB's 2004/1/1 fallback, used when the
# nav header carries no ION ALPHA/BETA — the UrbanNav nav files don't).
DEFAULT_ION_ALPHA = (0.1118e-07, -0.7451e-08, -0.5961e-07, 0.1192e-06)
DEFAULT_ION_BETA = (0.1167e+06, -0.2294e+06, -0.1311e+06, 0.1049e+07)


def klobuchar(t_tow, lat, lon, az, el, alpha=DEFAULT_ION_ALPHA,
              beta=DEFAULT_ION_BETA):
    """Klobuchar broadcast iono delay (m, L1) — vectorized over az/el.

    lat/lon in radians; az/el in radians; t_tow seconds of GPS week.
    """
    az = np.asarray(az, float)
    el = np.asarray(el, float)
    psi = 0.0137 / (el / np.pi + 0.11) - 0.022
    phi = lat / np.pi + psi * np.cos(az)
    phi = np.clip(phi, -0.416, 0.416)
    lam = lon / np.pi + psi * np.sin(az) / np.cos(phi * np.pi)
    phi_m = phi + 0.064 * np.cos((lam - 1.617) * np.pi)
    t = 43200.0 * lam + np.asarray(t_tow, float) % 86400.0
    t = t % 86400.0
    f = 1.0 + 16.0 * (0.53 - el / np.pi) ** 3
    amp = alpha[0] + phi_m * (alpha[1] + phi_m * (alpha[2] + phi_m * alpha[3]))
    per = beta[0] + phi_m * (beta[1] + phi_m * (beta[2] + phi_m * beta[3]))
    amp = np.maximum(amp, 0.0)
    per = np.maximum(per, 72000.0)
    x = 2.0 * np.pi * (t - 50400.0) / per
    ion = np.where(np.abs(x) < 1.57,
                   5e-9 + amp * (1.0 + x * x * (-0.5 + x * x / 24.0)),
                   5e-9)
    return CLIGHT * f * ion


def saastamoinen(lat, h, el, humidity=0.7):
    """Saastamoinen troposphere delay (m) — vectorized over elevation.

    Standard-atmosphere pressure/temperature at height h, as RTKLIB's
    ``tropmodel``.
    """
    el = np.asarray(el, float)
    h = max(0.0, min(h, 11000.0))
    pres = 1013.25 * (1.0 - 2.2557e-5 * h) ** 5.2568
    temp = 15.0 - 6.5e-3 * h + 273.16
    e = 6.108 * humidity * np.exp((17.15 * temp - 4684.0) / (temp - 38.45))
    z = np.pi / 2.0 - np.maximum(el, np.deg2rad(1.0))
    trph = 0.0022768 * pres / (1.0 - 0.00266 * np.cos(2.0 * lat)
                               - 0.00028 * h / 1e3) / np.cos(z)
    trpw = 0.002277 * (1255.0 / temp + 0.05) * e / np.cos(z)
    return trph + trpw
