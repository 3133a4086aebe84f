"""GNSS_Tools helpers: PRN classification, DOP, skyplot (port of ``glio_tpu/gnss/tools.py``).

The PRN classifiers (``PRNisGPS/GLONASS/Beidou/GAL``, gnss_tools.h:1116-1175,
one packed PRN space for all constellations) and the skyplot projection are
numpy, as in the JAX package; ``dop`` is torch and takes a leading epoch
axis.
"""

import numpy as np
import torch

from ..solver.linalg import spd_solve
from ..utils import coords as C

# The reference's packed PRN ranges (gnss_tools.h:1116-1175).
#   GPS: 1-32, GLONASS: 33-56 & 87-96, BDS: 88-121 & 161-195, GAL: 58-92.
# The published ranges overlap; the check order is the reference's:
# GPS → GLONASS → Beidou → Galileo.


def prn_is_gps(prn):
    return (prn >= 1) & (prn <= 32)


def prn_is_glonass(prn):
    return ((prn > 32) & (prn <= 56)) | ((prn >= 87) & (prn <= 96))


def prn_is_beidou(prn):
    return ((prn <= 121) & (prn >= 88)) | ((prn <= 195) & (prn >= 161))


def prn_is_gal(prn):
    return (prn >= 58) & (prn <= 92) & ~prn_is_gps(prn) & ~prn_is_glonass(prn)


def classify_prn(prn):
    """Packed PRN → constellation id (0 GPS, 1 GLO, 2 GAL, 3 BDS, −1)."""
    prn = np.asarray(prn)
    out = np.full(prn.shape, -1, np.int8)
    out[np.asarray(prn_is_gal(prn))] = 2
    out[np.asarray(prn_is_beidou(prn))] = 3
    out[np.asarray(prn_is_glonass(prn))] = 1
    out[np.asarray(prn_is_gps(prn))] = 0
    return out


def dop(rcv_ecef, sat_pos, valid):
    """(GDOP, PDOP, HDOP, VDOP) from the satellite geometry in ENU, each of
    shape (...): rcv_ecef (..., 3), sat_pos (..., M, 3), valid (..., M)
    (the reference's DOP message, nlosExclusion/msg/DOP.msg)."""
    rcv = torch.broadcast_to(rcv_ecef[..., None, :], sat_pos.shape)
    enu = C.ecef2enu(sat_pos, rcv)
    los = enu / torch.clamp(torch.linalg.norm(enu, dim=-1, keepdim=True), min=1.0)
    A = torch.cat([los, torch.ones_like(los[..., :1])], dim=-1)
    A = torch.where(valid[..., None], A, torch.zeros_like(A))
    eye = torch.eye(4, dtype=A.dtype, device=A.device)
    Q = spd_solve(A.mT @ A + 1e-9 * eye, eye.expand(A.shape[:-2] + (4, 4)))
    d = torch.diagonal(Q, dim1=-2, dim2=-1)
    gdop = torch.sqrt(d.sum(-1))
    pdop = torch.sqrt(d[..., 0] + d[..., 1] + d[..., 2])
    hdop = torch.sqrt(d[..., 0] + d[..., 1])
    vdop = torch.sqrt(d[..., 2])
    return gdop, pdop, hdop, vdop


def skyplot_coordinates(az, el):
    """Satellite az/el → 2-D skyplot x/y (the nlosExclusion skyplot tool):
    radius = 90° − elevation, angle = azimuth."""
    az = np.asarray(az)
    el = np.asarray(el)
    r = (np.pi / 2 - el) / (np.pi / 2)
    return r * np.sin(az), r * np.cos(az)
