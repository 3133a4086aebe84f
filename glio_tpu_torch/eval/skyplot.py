"""Headless satellite skyplot (SVG).

Counterpart of the reference's live PyQt skyplot
(``nlosExclusion/src/puSkyplot.py``): satellites on a polar
azimuth/elevation projection — zenith at the centre, horizon at the rim,
elevation rings, per-constellation colors, tracks over the mission and
SNR-shaded sample dots. Pure-python SVG writer (no Qt/ROS/matplotlib),
usable in CI and on headless hosts. A copy of ``glio_tpu/eval/skyplot.py``
(numpy only), so that the port imports nothing of the JAX package.

Projection: r = (90° − elevation)/90°, x = r·sin(az), y = −r·cos(az)
(north up, east right — standard skyplot convention).
"""

import math
from typing import Optional

import numpy as np

SYS_NAMES = {0: "GPS", 1: "GLO", 2: "GAL", 3: "BDS"}
SYS_COLORS = {0: "#1f77b4", 1: "#d62728", 2: "#2ca02c", 3: "#ff7f0e"}


def _proj(az, el, cx, cy, radius):
    r = radius * (90.0 - np.degrees(el)) / 90.0
    return cx + r * np.sin(az), cy - r * np.cos(az)


def write_skyplot_svg(path: str, gnss, size: int = 640,
                      elevation_mask_deg: float = 15.0,
                      max_tracks: Optional[int] = None,
                      title: str = "skyplot") -> dict:
    """Render the mission's satellite visibility to an SVG file.

    Args:
      gnss: GnssEpochs (uses azimuth if present, else derives tracks from
        ``sat_pos`` being unavailable is an error only if azimuth absent;
        the converter stores elevation — azimuth is reconstructed from
        consecutive positions when a dedicated field is missing).
      elevation_mask_deg: draw the mask ring the estimator uses.
      max_tracks: cap on satellite tracks (longest first); None = all.

    Returns a summary dict (n_sats, n_epochs, per-system counts).
    """
    valid = np.asarray(gnss.valid)
    el = np.asarray(gnss.elevation)
    system = np.asarray(gnss.system)
    snr = np.asarray(gnss.snr)
    E, M = valid.shape
    az = getattr(gnss, "azimuth", None)
    if az is None:
        # Reconstruct azimuth from satellite ECEF positions relative to a
        # nominal receiver (the first epoch's mean satellite direction is
        # irrelevant for a VISIBILITY plot; we only need a consistent
        # az/el chart). Use the geometric az from sat_pos and the
        # receiver implied by the station field if present.
        sat_pos = np.asarray(gnss.sat_pos)
        rcv = sat_pos[valid].mean(axis=0)
        rcv = rcv / np.linalg.norm(rcv) * 6378137.0
        # ENU rotation at the receiver.
        lat = math.asin(rcv[2] / np.linalg.norm(rcv))
        lon = math.atan2(rcv[1], rcv[0])
        sl, cl = math.sin(lat), math.cos(lat)
        so, co = math.sin(lon), math.cos(lon)
        R = np.array([[-so, co, 0.0],
                      [-sl * co, -sl * so, cl],
                      [cl * co, cl * so, sl]])
        d = sat_pos - rcv
        enu = d @ R.T
        az = np.arctan2(enu[..., 0], enu[..., 1])

    az = np.asarray(az)
    cx = cy = size / 2.0
    radius = size / 2.0 - 30.0
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" '
        f'height="{size + 40}" viewBox="0 0 {size} {size + 40}">',
        f'<rect width="{size}" height="{size + 40}" fill="white"/>',
        f'<text x="{cx}" y="18" text-anchor="middle" font-size="14" '
        f'font-family="sans-serif">{title}</text>',
    ]
    # Elevation rings at 0/30/60 deg + the estimator's mask.
    for ring_el, dash in [(0, ""), (30, "4 3"), (60, "4 3")]:
        r = radius * (90 - ring_el) / 90.0
        parts.append(
            f'<circle cx="{cx}" cy="{cy}" r="{r:.1f}" fill="none" '
            f'stroke="#888" stroke-width="1"'
            + (f' stroke-dasharray="{dash}"' if dash else "") + "/>")
        parts.append(
            f'<text x="{cx + 4:.1f}" y="{cy - r + 12:.1f}" font-size="10" '
            f'fill="#888" font-family="sans-serif">{ring_el}&#176;</text>')
    r_mask = radius * (90 - elevation_mask_deg) / 90.0
    parts.append(
        f'<circle cx="{cx}" cy="{cy}" r="{r_mask:.1f}" fill="none" '
        f'stroke="#d33" stroke-width="1" stroke-dasharray="2 3"/>')
    for lab, ang in [("N", 0), ("E", 90), ("S", 180), ("W", 270)]:
        a = math.radians(ang)
        parts.append(
            f'<text x="{cx + (radius + 12) * math.sin(a):.1f}" '
            f'y="{cy - (radius + 12) * math.cos(a) + 4:.1f}" '
            f'text-anchor="middle" font-size="12" '
            f'font-family="sans-serif">{lab}</text>')

    # Per-satellite tracks: group samples by sat_id when available, else
    # by slot index.
    sat_id = (np.asarray(gnss.sat_id) if gnss.sat_id is not None
              else np.tile(np.arange(M), (E, 1)))
    tracks = {}
    for e in range(E):
        for m in range(M):
            if not valid[e, m]:
                continue
            tracks.setdefault(int(sat_id[e, m]), []).append(
                (az[e, m], el[e, m], float(snr[e, m]), int(system[e, m])))
    order = sorted(tracks, key=lambda k: -len(tracks[k]))
    if max_tracks:
        order = order[:max_tracks]
    per_sys = {}
    for sid in order:
        pts = tracks[sid]
        sysid = pts[0][3]
        per_sys[SYS_NAMES.get(sysid, str(sysid))] = per_sys.get(
            SYS_NAMES.get(sysid, str(sysid)), 0) + 1
        color = SYS_COLORS.get(sysid, "#555")
        xs, ys = _proj(np.array([p[0] for p in pts]),
                       np.array([p[1] for p in pts]), cx, cy, radius)
        step = max(len(xs) // 200, 1)     # bound SVG size
        path_d = "M" + " L".join(
            f"{x:.1f},{y:.1f}" for x, y in zip(xs[::step], ys[::step]))
        parts.append(f'<path d="{path_d}" fill="none" stroke="{color}" '
                     f'stroke-width="1" opacity="0.6"/>')
        # SNR-shaded end dot + PRN label at the last sample.
        s = max(min(pts[-1][2], 55.0), 20.0)
        op = 0.25 + 0.75 * (s - 20.0) / 35.0
        parts.append(f'<circle cx="{xs[-1]:.1f}" cy="{ys[-1]:.1f}" r="4" '
                     f'fill="{color}" opacity="{op:.2f}"/>')
        prn = sid % 100 if gnss.sat_id is not None else sid
        parts.append(
            f'<text x="{xs[-1] + 6:.1f}" y="{ys[-1] + 4:.1f}" '
            f'font-size="9" fill="{color}" font-family="sans-serif">'
            f'{SYS_NAMES.get(sysid, "?")[0]}{prn:02d}</text>')

    # Legend.
    lx = 10
    for i, (sysid, name) in enumerate(sorted(SYS_NAMES.items())):
        if name not in per_sys:
            continue
        y = size + 14 + 0 * i
        parts.append(f'<circle cx="{lx}" cy="{y}" r="4" '
                     f'fill="{SYS_COLORS[sysid]}"/>')
        parts.append(f'<text x="{lx + 8}" y="{y + 4}" font-size="11" '
                     f'font-family="sans-serif">{name} '
                     f'({per_sys[name]})</text>')
        lx += 90
    parts.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(parts))
    return {"n_sats": len(order), "n_epochs": int(E),
            "per_system": per_sys}
