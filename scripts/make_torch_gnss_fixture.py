"""JAX fixtures for the PyTorch port's GNSS phase (``chip_smoke.py`` phase 15).

Runs ``glio_tpu`` on the CPU (its batch solves in f64, ``mixed=False``, the
port's arithmetic) and writes, under ``tests/data/``:

* ``gnss_T3493_seed15.npz`` (``--only rinex``) — RINEX at the Whampoa
  length: ``testing.write_synthetic_rinex`` along ``testing.gnss_drive``
  (the batch fixture's 3493-keyframe drive, an epoch every third keyframe:
  1165 at 1 Hz, 8 GPS + 6 BDS satellites) and the files' sha256; JAX's
  ``convert`` of them, as per-field digests (``testing.gnss_fields_digest``);
  ``spp.solve_epochs`` of every epoch from the station (ok, positions, and
  their spread under a ±1e-9 m nudge of the start and a ±1e-8 m nudge of
  the pseudoranges of alternating sign across satellites), Doppler velocity
  and DOP at those fixes; the level-0 batch with Doppler rows
  (``testing.gnss_batch_config``, the bench robust options, 4 stages x 10 LM
  iterations) on the drifted odometry and the converted epochs, with the
  direct solver and with ``chol_pcg``: p, q and their spread under a
  ±1e-9 m nudge of the odometry (for ``chol_pcg`` also under an
  f32-resolution rescaling of its preconditioner, ``chol_pcg_f32_spread``),
  and the problem's checksums.
* ``long_run_seed3.npz`` (``--only long_run``) — ``run_pipeline(...,
  backend_fusion_every=10)`` in the configuration of
  ``scripts/long_run.py:26-36`` (``testing.long_run_config``) on
  ``testing.LONG_RUN`` (30 keyframes): the CSV rows of stages 1 and 2, the
  fusion's debug lines and reset decisions, n_lidar_factors at every step,
  and the positions' spread under ±1e-9 m nudges of p0 (``decisions_stable``).
* ``window_doppler_seed0.npz`` (``--only doppler_window``) — ``run_pipeline``
  (stages 1-3) in ``testing.doppler_window_config`` on phase 7's 15
  keyframes with GNSS at every keyframe: the CSV rows, the replay's
  n_lidar_factors and receiver clock drift, and their spread under ±1e-9 m
  nudges of p0.
* ``window_gnss_spread_seed21.npz`` (``--only window_test``) — the spread of
  JAX's GNSS-window replay with Doppler rows under ±1e-9 m nudges of p0, per
  keyframe, for ``tests/test_torch_window_gnss_replay.py``.

Each file stores its configuration and scenario. ``rinex`` takes about ten
minutes, the others a few:

    JAX_PLATFORMS=cpu python scripts/make_torch_gnss_fixture.py [--only NAME]
"""

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import os
import sys
import tempfile
import time
import unittest.mock

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from glio_tpu_torch import testing  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
OUT = {"rinex": "gnss_T3493_seed15.npz", "long_run": "long_run_seed3.npz",
       "doppler_window": "window_doppler_seed0.npz",
       "window_test": "window_gnss_spread_seed21.npz"}
WINDOW_TEST = dict(n_keyframes=12, scan_points=512, seed=21, psr_noise=0.3)
NUDGE_M = 1e-9
NUDGE_PSR_M = 1e-8


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def _config_json(cfg):
    return json.dumps(dataclasses.asdict(cfg))


def _checksums(*arrays):
    return np.array([[np.asarray(a, float).sum(), (np.asarray(a, float) ** 2).sum()]
                     for a in arrays])


def make_rinex():
    jax = _jax()
    import jax.numpy as jnp
    from glio_tpu import config as jcfg
    from glio_tpu.gnss import converter as jconv
    from glio_tpu.gnss import spp as jspp
    from glio_tpu.gnss import tools as jtools
    from glio_tpu.models import batch as JB
    sc = dict(testing.GNSS_DRIVE)
    cfg = testing.gnss_batch_config(jcfg)
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    kf_time, p_true, q_true, p_odo, t_gps, rover = testing.gnss_drive(sc)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        obs, nav = os.path.join(d, "drive.obs"), os.path.join(d, "drive.nav")
        info = testing.write_synthetic_rinex(obs, nav, t_gps, rover, seed=sc["seed"],
                                             n_gps=sc["n_gps"], n_bds=sc["n_bds"],
                                             psr_noise=sc["psr_noise"])
        out["rinex_sha256"] = testing.files_digest(obs, nav)
        out["obs_bytes"], out["nav_bytes"] = os.path.getsize(obs), os.path.getsize(nav)
        t0 = time.perf_counter()
        g = jconv.convert(obs, nav, station)
        print(f"JAX convert {time.perf_counter() - t0:.2f} s, {g.time.shape[0]} epochs, "
              f"satellites {info['sats']}", flush=True)
    out["gnss_digest_json"] = json.dumps(testing.gnss_fields_digest(g))

    # SPP, Doppler velocity and DOP of every epoch.
    def spp(x0, psr):
        return [np.asarray(a) for a in jspp.solve_epochs(
            jnp.asarray(g.sat_pos), jnp.asarray(psr), jnp.asarray(g.system.astype(np.int32)),
            jnp.asarray(g.valid), jnp.asarray(g.elevation), jnp.asarray(g.snr),
            jnp.asarray(x0))]
    x, clk, ok, rms = spp(station, g.psr_rov_corr)
    alt = np.where(np.arange(g.psr_rov_corr.shape[1]) % 2 == 0, 1.0, -1.0)
    spread = 0.0
    for x0, psr in ((station + NUDGE_M, g.psr_rov_corr), (station - NUDGE_M, g.psr_rov_corr),
                    (station, g.psr_rov_corr + NUDGE_PSR_M * alt),
                    (station, g.psr_rov_corr - NUDGE_PSR_M * alt)):
        xn, _, okn, _ = spp(x0, psr)
        assert np.array_equal(okn, ok)
        spread = max(spread, float(np.abs(xn - x)[ok].max()))
    v, ddt = (np.asarray(a) for a in jax.vmap(jspp.doppler_velocity)(
        jnp.asarray(g.sat_pos), jnp.asarray(g.sat_vel), jnp.asarray(g.dopp_rov),
        jnp.asarray(g.system.astype(np.int32)), jnp.asarray(g.valid), jnp.asarray(g.elevation),
        jnp.asarray(g.snr), jnp.asarray(x)))
    dops = np.stack([np.asarray(a) for a in jax.vmap(jtools.dop)(
        jnp.asarray(x), jnp.asarray(g.sat_pos), jnp.asarray(g.valid))], -1)
    rmse = float(np.sqrt(np.mean(np.sum((x - rover) ** 2, -1))))
    print(f"SPP: {int(ok.sum())} of {ok.shape[0]} ok, RMSE {rmse:.3f} m, JAX's spread under "
          f"the nudges {spread:.3e} m", flush=True)
    out.update(spp_ok=ok, spp_x=x, spp_clk=clk, spp_rms=rms, spp_nudge_dp=spread,
               spp_rmse=rmse, dopp_v=v, dopp_ddt=ddt, dop=dops)

    # The level-0 batch with Doppler rows, direct and chol_pcg.
    robust = JB.RobustOpts(dd_huber=1.0, epoch_gate=2.0, rel_huber=5.0)
    kw = dict(thresholds=testing.GNSS_BATCH["thresholds"],
              lm_iters=testing.GNSS_BATCH["lm_iters"], robust=robust, mixed=False)
    prob = JB.build_problem(cfg, p_odo, q_true, kf_time, g, anchor, 0.0, station)
    out["checksums"] = _checksums(prob.p_odo, prob.psr_rov, prob.psr_sta, prob.whiten,
                                  prob.ep_valid, prob.dopp, prob.dopp_sigma, prob.sat_vel)
    for key, solver in (("", "direct"), ("_cp", "chol_pcg")):
        t0 = time.perf_counter()
        p, q, costs = JB.optimize_batch(cfg, prob, solver=solver, **kw)
        p, q = np.asarray(p), np.asarray(q)
        dt = time.perf_counter() - t0
        dp = dq = 0.0
        for nudge in (NUDGE_M, -NUDGE_M):
            prob_n = JB.build_problem(cfg, p_odo + nudge, q_true, kf_time, g, anchor, 0.0,
                                      station)
            pn, qn, _ = JB.optimize_batch(cfg, prob_n, solver=solver, **kw)
            dp = max(dp, float(np.abs(np.asarray(pn) - p).max()))
            dq = max(dq, float(np.abs(np.asarray(qn) - q).max()))
        err = float(np.sqrt(np.mean(np.sum((p - p_true) ** 2, -1))))
        print(f"batch {solver}: {dt:.1f} s, costs {costs}, RMSE vs truth {err:.4f} m, nudge "
              f"spread dp {dp:.3e} m, dq {dq:.3e}", flush=True)
        out.update({f"p{key}": p, f"q{key}": q, f"costs{key}": np.asarray(costs),
                    f"nudge_dp{key}": dp, f"nudge_dq{key}": dq, f"rmse{key}": err})
    out.update(chol_pcg_f32_spread(cfg, prob, kw, out["p_cp"], out["q_cp"]))
    out["rmse_odo"] = float(np.sqrt(np.mean(np.sum((p_odo - p_true) ** 2, -1))))
    return cfg, sc, out


def chol_pcg_f32_spread(cfg, prob, kw, p, q):
    """JAX's ``chol_pcg`` spread under a change of its f32 preconditioner at
    f32 resolution: the equilibration scaled by 1 ± 2^-23 on alternate block
    rows (a valid preconditioner of the same system, whose f32 factor rounds
    differently). A ±1e-9 m nudge of the odometry leaves most of the f32
    band's bits as they are, so it does not show how far another f32
    rounding of the same factor (another device's) may move the 14 CG
    iterations. Returns the ``f32_nudge_dp_cp`` / ``f32_nudge_dq_cp`` keys."""
    jax = _jax()
    import jax.numpy as jnp
    from glio_tpu.models import batch as JB
    from glio_tpu.solver import banded as JBand
    equilibrate = JBand._equilibrate
    dp = dq = 0.0
    for sign in (1.0, -1.0):
        def rescaled(band, sign=sign):
            band_s, s = equilibrate(band)
            T, B = band.shape[:2]
            hw = (B - 1) // 2
            f = 1.0 + sign * 2.0 ** -23 * jnp.where(jnp.arange(T) % 2 == 0, 1.0, -1.0)
            idx = jnp.arange(T)
            cols = [jnp.where((idx + o - hw >= 0) & (idx + o - hw < T),
                              jnp.roll(f, hw - o), 1.0) for o in range(B)]
            F = jnp.stack(cols, 1)
            return band_s * f[:, None, None, None] * F[:, :, None, None], s * f[:, None]
        jax.clear_caches()
        with unittest.mock.patch.object(JBand, "_equilibrate", rescaled):
            pn, qn, _ = JB.optimize_batch(cfg, prob, solver="chol_pcg", **kw)
        dp = max(dp, float(np.abs(np.asarray(pn) - p).max()))
        dq = max(dq, float(np.abs(np.asarray(qn) - q).max()))
    jax.clear_caches()
    print(f"batch chol_pcg: spread under an f32-resolution rescaling of its preconditioner "
          f"dp {dp:.3e} m, dq {dq:.3e}", flush=True)
    return {"f32_nudge_dp_cp": dp, "f32_nudge_dq_cp": dq}


def _run_jax_pipeline(cfg, ep, nudge, **kw):
    """JAX's ``run_pipeline`` with its batch solves in f64 and the backend
    fusion's debug lines on; returns (CSV rows by name, debug lines,
    n_lidar_factors recorded from the replay chunks, or None)."""
    from glio_tpu import pipeline as jpipe
    from glio_tpu.models import batch as JB
    from glio_tpu.models import sliding_window as jsw
    nlf = []
    make_replay = jsw.make_replay

    def recording_make_replay(c):
        replay, step = make_replay(c)
        inner = replay.replay_from

        def replay_from(carry, part):
            carry, o = inner(carry, part)
            nlf.append(np.asarray(o.n_lidar_factors))
            return carry, o
        replay.replay_from = replay_from
        return replay, step

    ep = dataclasses.replace(ep, p0=ep.p0 + nudge)
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(buf), \
            unittest.mock.patch.object(JB, "optimize_batch",
                                       functools.partial(JB.optimize_batch, mixed=False)), \
            unittest.mock.patch.object(jpipe, "replay_with_backend_fusion", functools.partial(
                jpipe.replay_with_backend_fusion, debug=True)), \
            unittest.mock.patch.object(jpipe, "make_replay", recording_make_replay), \
            unittest.mock.patch.object(jsw, "make_replay", recording_make_replay):
        jpipe.run_pipeline(ep, cfg, out_dir=d, **kw)
        rows = {n: np.loadtxt(os.path.join(d, n + ".csv"), delimiter=",", ndmin=2)
                for n in ("tc_sw_result", "tc_batch_result")}
    return rows, buf.getvalue().splitlines(), (np.concatenate(nlf) if nlf else None)


def _csv_spread(rows, rows_n):
    """Largest |ENU|, altitude and lat/lon (m) difference of two CSVs."""
    return max(float(np.abs(rows_n[:, 9:12] - rows[:, 9:12]).max()),
               float(np.abs(rows_n[:, 5] - rows[:, 5]).max()),
               111_320.0 * float(np.abs(rows_n[:, 3:5] - rows[:, 3:5]).max()))


def make_long_run():
    _jax()
    from glio_tpu import config as jcfg
    from glio_tpu.data import simulator as jsim
    sc = dict(testing.LONG_RUN)
    cfg = testing.long_run_config(jcfg)
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    ep = testing.gnss_episode(sc, jsim.simulate_episode, jsim.simulate_gnss_epochs, anchor,
                              station)
    t0 = time.perf_counter()
    rows, lines, nlf = _run_jax_pipeline(cfg, ep, 0.0, backend_fusion_every=sc["every"])
    assert nlf is not None and nlf.shape == (sc["n_keyframes"],)
    print(f"long run: {time.perf_counter() - t0:.1f} s; resets "
          f"{testing.reset_decisions(lines)}", flush=True)
    out = dict(tc_sw_result=rows["tc_sw_result"], tc_batch_result=rows["tc_batch_result"],
               lines=json.dumps(lines), n_lidar_factors=nlf)
    sw = bt = 0.0
    stable = True
    for nudge in (NUDGE_M, -NUDGE_M):
        rows_n, lines_n, nlf_n = _run_jax_pipeline(cfg, ep, nudge,
                                                   backend_fusion_every=sc["every"])
        stable &= testing.reset_decisions(lines_n) == testing.reset_decisions(lines)
        stable &= bool(np.array_equal(nlf_n, nlf))
        sw = max(sw, _csv_spread(rows["tc_sw_result"], rows_n["tc_sw_result"]))
        bt = max(bt, _csv_spread(rows["tc_batch_result"], rows_n["tc_batch_result"]))
    print(f"long run nudge spread: stage 1 {sw:.3e} m, stage 2 {bt:.3e} m; decisions and "
          f"n_lidar_factors stable {stable}", flush=True)
    err = np.linalg.norm(rows["tc_sw_result"][:, 9:12] - ep.gt_p, axis=-1)
    out.update(sw_nudge_dp=sw, batch_nudge_dp=bt, decisions_stable=stable,
               ate_sw_rmse=float(np.sqrt(np.mean(err ** 2))))
    return cfg, sc, out


def make_doppler_window():
    jax = _jax()
    from glio_tpu import config as jcfg
    from glio_tpu.data import simulator as jsim
    from glio_tpu.models.sliding_window import make_replay
    sc = dict(testing.DOPPLER_WINDOW)
    cfg = testing.doppler_window_config(jcfg)
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    ep = testing.gnss_episode(sc, jsim.simulate_episode, jsim.simulate_gnss_epochs, anchor,
                              station)
    replay = make_replay(cfg)[0]

    def replay_out(nudge):
        o = replay(ep.to_inputs(), ep.p0 + nudge, ep.q0, ep.v0, ep.acc0, ep.gyr0)
        return jax.tree.map(np.asarray, o)
    t0 = time.perf_counter()
    rows, _, _ = _run_jax_pipeline(cfg, ep, 0.0)
    o = replay_out(0.0)
    print(f"doppler window: {time.perf_counter() - t0:.1f} s, ddt {o.ddt}", flush=True)
    out = dict(tc_sw_result=rows["tc_sw_result"], tc_batch_result=rows["tc_batch_result"],
               n_lidar_factors=o.n_lidar_factors, ddt=o.ddt, p=o.p)
    sw = bt = dd = 0.0
    stable = True
    for nudge in (NUDGE_M, -NUDGE_M):
        rows_n, _, _ = _run_jax_pipeline(cfg, ep, nudge)
        on = replay_out(nudge)
        stable &= bool(np.array_equal(on.n_lidar_factors, o.n_lidar_factors))
        sw = max(sw, _csv_spread(rows["tc_sw_result"], rows_n["tc_sw_result"]))
        bt = max(bt, _csv_spread(rows["tc_batch_result"], rows_n["tc_batch_result"]))
        dd = max(dd, float(np.abs(on.ddt - o.ddt).max()))
    print(f"doppler window nudge spread: stage 1 {sw:.3e} m, stage 2 {bt:.3e} m, ddt "
          f"{dd:.3e} m/s; n_lidar_factors stable {stable}", flush=True)
    out.update(sw_nudge_dp=sw, batch_nudge_dp=bt, ddt_nudge=dd, nlf_stable=stable)
    return cfg, sc, out


def make_window_test():
    """JAX's own spread under ±1e-9 m nudges of p0, per keyframe, of the
    GNSS-window replay with Doppler rows in ``tests/test_torch_window_gnss_replay.py``
    (the JAX package's e2e shapes, ``WINDOW_TEST``)."""
    _jax()
    from glio_tpu.config import EstimatorConfig, GlioConfig, ShapeConfig
    from glio_tpu.data import simulator as jsim
    from glio_tpu.models.sliding_window import make_replay
    sc = dict(WINDOW_TEST)
    cfg = GlioConfig().replace(
        shapes=ShapeConfig(max_imu_per_interval=40, scan_points=sc["scan_points"],
                           map_points=4096),
        estimator=EstimatorConfig(local_map_width=8, sw_max_iter=8, gnss_in_sliding_window=True,
                                  doppler_in_window=True))
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    ep = jsim.simulate_episode(n_keyframes=sc["n_keyframes"], scan_points=sc["scan_points"],
                               seed=sc["seed"])
    ep.gnss = jsim.simulate_gnss_epochs(ep.gt_p, ep.kf_time, anchor, station,
                                        psr_noise=sc["psr_noise"], epoch_stride=1,
                                        seed=sc["seed"])
    replay = make_replay(cfg)[0]

    def run(nudge):
        o = replay(ep.to_inputs(), ep.p0 + nudge, ep.q0, ep.v0, ep.acc0, ep.gyr0)
        return {f: np.asarray(getattr(o, f)) for f in ("p", "q", "ddt")}
    o = run(0.0)
    out = {f"spread_{f}": np.zeros(o[f].shape[0]) for f in o}
    for nudge in (NUDGE_M, -NUDGE_M):
        on = run(nudge)
        for f in o:
            d = np.abs(on[f] - o[f]).reshape(o[f].shape[0], -1).max(-1)
            out[f"spread_{f}"] = np.maximum(out[f"spread_{f}"], d)
    print("window test spreads: " + ", ".join(f"{k} {v.max():.3e}" for k, v in out.items()),
          flush=True)
    return cfg, sc, out


MAKERS = {"rinex": make_rinex, "long_run": make_long_run, "doppler_window": make_doppler_window,
          "window_test": make_window_test}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=sorted(MAKERS))
    args = ap.parse_args()
    for name in ([args.only] if args.only else list(MAKERS)):
        cfg, sc, out = MAKERS[name]()
        path = os.path.join(DATA, OUT[name])
        np.savez_compressed(path, config_json=_config_json(cfg), scenario_json=json.dumps(sc),
                            **out)
        print(f"wrote {path} ({os.path.getsize(path) / 2**10:.0f} KiB)", flush=True)


if __name__ == "__main__":
    main()
