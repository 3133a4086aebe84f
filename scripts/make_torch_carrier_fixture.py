"""JAX fixture for the PyTorch port's carrier-phase path (``chip_smoke.py``
phase 15.6).

Runs ``glio_tpu`` on the CPU and writes ``tests/data/carrier_T3493_seed15.npz``:
the synthetic RINEX 3 drive of phase 15 (``testing.GNSS_DRIVE``: the
3493-keyframe drifted drive, 1165 epochs at 1 Hz, 8 GPS + 6 BDS satellites,
integer carrier ambiguities; the station's carrier synthesized by the
converter) converted by JAX's ``convert``; then the float/AR variant of
stage 3 as ``tests/test_lc_fusion.py:170-200`` composes it:
``rtk.run_float_filter`` from ``x0`` (the first odometry pose in ECEF),
``lambda_ar.resolve_trajectory`` (the per-constellation wavelengths), the
fixed position where the ratio test passed, σ capped at 0.5 m there, the
5 m covariance gate, the association to keyframes within 0.25 s and
``lc_fusion.solve`` (8 GN iterations, GNSS Huber 2) over the drifted
odometry at T = 3493.

Stored: the filter's pos, vel, pos_cov, amb, ok, n_dd, n_car and consist
of every epoch, amb_cov and pa_cov of every 25th epoch (``sub``), the AR
flags and ratios, the gated fixes and the LC trajectory; and JAX's own
spread, which the port's tolerances are set from: the largest change of
each under a ±1e-9 m nudge of x0 and under a ±1e-8 m nudge of the rover
pseudoranges of alternating sign across satellites (the nudges of phase 10),
covariances relative to their epoch's largest entry (``nudge_*``); and which
AR flags none of the four nudges changes (``fixed_stable``).

    JAX_PLATFORMS=cpu python scripts/make_torch_carrier_fixture.py    # ~5 min
"""

import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from glio_tpu_torch import testing  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "carrier_T3493_seed15.npz")
CARRIER = dict(x0_nudge_m=1e-9, psr_nudge_m=1e-8, cov_gate=5.0, max_dt=0.25, sub=25)


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def converted_epochs(cfg):
    """Phase 15's RINEX written and converted by JAX; returns (drive, g)."""
    from glio_tpu.gnss import converter as jconv
    sc = testing.GNSS_DRIVE
    drive = testing.gnss_drive(sc)
    with tempfile.TemporaryDirectory() as d:
        obs, nav = os.path.join(d, "drive.obs"), os.path.join(d, "drive.nav")
        testing.write_synthetic_rinex(obs, nav, drive[4], drive[5], seed=sc["seed"],
                                      n_gps=sc["n_gps"], n_bds=sc["n_bds"],
                                      psr_noise=sc["psr_noise"])
        g = jconv.convert(obs, nav, np.asarray(cfg.initialization.station_ecef))
    return drive, g


def float_ar_lc(g, kf_time, p_sw, q_sw, anchor, station, x0):
    """The JAX composition: a dict of numpy arrays."""
    import jax.numpy as jnp
    from glio_tpu.eval.trajectory import associate
    from glio_tpu.gnss import lambda_ar, rtk
    from glio_tpu.models import lc_fusion
    from glio_tpu.utils import coords as C
    t0 = time.perf_counter()
    flt = rtk.run_float_filter(g, station, x0)
    flt = type(flt)(*(np.asarray(a) for a in flt))
    t_flt = time.perf_counter() - t0
    sig = np.sqrt(np.maximum(np.trace(flt.pos_cov, axis1=1, axis2=2) / 3, 1e-6))
    ok = flt.ok & (sig < CARRIER["cov_gate"])
    t0 = time.perf_counter()
    pos_ar, fixed, ratio = lambda_ar.resolve_trajectory(g, flt)
    t_ar = time.perf_counter() - t0
    fixes = flt.pos.copy()
    fixes[fixed] = pos_ar[fixed]
    sig = np.where(fixed, np.minimum(sig, 0.5), sig)
    enu = np.asarray(C.ecef2enu(jnp.asarray(fixes), jnp.asarray(anchor)))
    T = p_sw.shape[0]
    ia, ib = associate(kf_time, g.time, max_dt=CARRIER["max_dt"])
    gp, gv, gs = np.zeros((T, 3)), np.zeros(T, bool), np.ones(T)
    for a, b in zip(ia, ib):
        if ok[b]:
            gp[a], gv[a], gs[a] = enu[b], True, max(sig[b], 0.5)
    prob = lc_fusion.build_problem(p_sw, q_sw, gp, gv, gs, min_spacing_m=5.0)
    p, q, _ = lc_fusion.solve(prob, jnp.asarray(p_sw), jnp.asarray(q_sw), gn_iters=8,
                              gnss_huber=2.0)
    sub = np.arange(0, flt.pos.shape[0], CARRIER["sub"])
    print(f"  filter {t_flt:.1f} s, AR {t_ar:.1f} s: {int(fixed.sum())} of "
          f"{int(flt.ok.sum())} ok epochs fixed, {int(gv.sum())} keyframes with a fix",
          flush=True)
    return dict(pos=flt.pos, vel=flt.vel, pos_cov=flt.pos_cov, amb=flt.amb, ok=flt.ok,
                n_dd=flt.n_dd, n_car=flt.n_car, consist=flt.consist, sub=sub,
                amb_cov_sub=flt.amb_cov[sub], pa_cov_sub=flt.pa_cov[sub], fixed=fixed,
                ratio=ratio, gnss_p=gp, gnss_valid=gv, gnss_sigma=gs, p_lc=np.asarray(p),
                q_lc=np.asarray(q))


def rel_spread(a, b):
    """The largest change of each epoch's entries relative to its largest."""
    scale = np.abs(b).reshape(b.shape[0], -1).max(1)
    return float((np.abs(a - b).reshape(b.shape[0], -1).max(1) / np.maximum(scale, 1e-300))
                 .max())


def main():
    _jax()
    import jax.numpy as jnp
    from glio_tpu.config import GlioConfig
    from glio_tpu.utils import coords as C
    cfg = GlioConfig()
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    t0 = time.perf_counter()
    (kf_time, p_true, q_true, p_odo, _, rover), g = converted_epochs(cfg)
    print(f"converted {g.time.shape[0]} epochs in {time.perf_counter() - t0:.1f} s", flush=True)
    x0 = np.asarray(C.enu2ecef(jnp.asarray(p_odo[0]), jnp.asarray(anchor)))
    out = float_ar_lc(g, kf_time, p_odo, q_true, anchor, station, x0)
    runs = []
    for s in (1.0, -1.0):
        runs.append(float_ar_lc(g, kf_time, p_odo, q_true, anchor, station,
                                x0 + s * CARRIER["x0_nudge_m"]))
        alt = s * (-1.0) ** np.arange(g.psr_rov.shape[1])
        g_n = dataclasses.replace(g, psr_rov=g.psr_rov + CARRIER["psr_nudge_m"] * alt * g.valid)
        runs.append(float_ar_lc(g_n, kf_time, p_odo, q_true, anchor, station, x0))
    for key in ("pos", "vel", "amb", "p_lc", "q_lc", "gnss_p"):
        out[f"nudge_{key}"] = np.array(max(float(np.abs(r[key] - out[key]).max())
                                           for r in runs))
    for key in ("pos_cov", "amb_cov_sub", "pa_cov_sub"):
        out[f"nudge_{key}"] = np.array(max(rel_spread(r[key], out[key]) for r in runs))
    out["fixed_stable"] = np.all([r["fixed"] == out["fixed"] for r in runs], axis=0)
    for key in ("ok", "n_dd", "n_car", "gnss_valid"):
        same = all(np.array_equal(r[key], out[key]) for r in runs)
        print(f"  {key} {'stable' if same else 'MOVES'} under the nudges", flush=True)
    out["x0"] = x0
    out["rmse_float"] = np.array(np.sqrt(np.mean(np.sum(
        (out["pos"][out["ok"]] - rover[out["ok"]]) ** 2, -1))))
    out["rmse_lc"] = np.array(np.sqrt(np.mean(np.sum((out["p_lc"] - p_true) ** 2, -1))))
    out["config_json"] = np.array(json.dumps(dataclasses.asdict(cfg)))
    out["scenario_json"] = np.array(json.dumps({**testing.GNSS_DRIVE, **CARRIER}))
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 2**20:.2f} MiB): "
          f"{int(out['fixed'].sum())} epochs fixed ({int((~out['fixed_stable']).sum())} flags "
          f"move under the nudges); spreads pos {float(out['nudge_pos']):.3e} m, vel "
          f"{float(out['nudge_vel']):.3e} m/s, amb {float(out['nudge_amb']):.3e} m, pos_cov "
          f"{float(out['nudge_pos_cov']):.3e} (rel), LC p {float(out['nudge_p_lc']):.3e} m, "
          f"q {float(out['nudge_q_lc']):.3e}; RMSE float {float(out['rmse_float']):.3f} m, "
          f"LC {float(out['rmse_lc']):.3f} m", flush=True)


if __name__ == "__main__":
    main()
