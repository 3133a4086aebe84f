"""JAX fixtures for the PyTorch port's stage 3, backend fusion, loop closure
and dense-frame / map-export paths.

Runs ``glio_tpu`` on the CPU (its batch solves in f64, ``mixed=False``, the
port's arithmetic) and writes, under ``tests/data/``:

* ``lc_T3493_seed4.npz`` (``--only lc``) — stage 3 on the batch fixture's
  drive: ``drifted_trajectory(3493)`` as the stage-1 chain (truth
  attitudes), ``simulate_gnss_epochs(psr_noise=0.5, epoch_stride=3,
  seed=4)``, default ``GlioConfig``. Every epoch's RTK DD fix (fix, ok,
  √(tr Σ / 3)), the covariance gate and nearest-time association, and
  ``lc_fusion.solve``'s p and q. JAX's own spread: the fixes, p and q
  under a nudge of the rover pseudoranges by 1e-8 m of alternating sign
  across satellites (``nudge_fix``, ``nudge_fix_dp``, ``nudge_fix_dq``; a
  common offset cancels in the double differences, and 1e-9 m is below the
  spacing of f64 values at a 2e7 m range), p and q under a ±1e-9 m nudge of
  the odometry (``nudge_dp``, ``nudge_dq``).
* ``backend_fusion_w50_seed21.npz`` (``--only fusion``) — the divergence
  scenario of ``tests/test_pipeline_aux.py::test_divergence_recovery_via_config_gates``
  (IMU specific force +1.5 m/s² on keyframes 12-21, LiDAR blinded on
  12-25, GNSS at every keyframe, ``every=8``, ``fusion_span=48``) at the
  ``bench.py`` shapes (window 5, map width 50, 1024-point scans,
  16,384-point map, 15 LM iterations) over ``--fusion-keyframes`` (48)
  keyframes: p and q of ``replay_with_backend_fusion``, its ``debug`` lines
  and reset decisions (keyframe, branch), and the same under ±1e-9 m nudges
  of p0 (``nudge_dp``; ``decisions_stable``).
* ``backend_fusion_small_seed21.npz`` (``--only fusion_small``) — the same
  scenario at the JAX test's own shapes (256-point scans, map 4096, width
  8, 8 LM iterations), both arms (gates at 20 m / 8 m, and disabled), with
  their decisions and the nudge spread of the gated arm: the CPU test's
  reference.
* ``loop_closure_seed17.npz`` (``--only loop``) — ``apply_loop_closure`` on
  a two-lap ``circle_omega`` drive (132 keyframes, a lap in 22 s, radius
  ~17.5 m) of 1024-point scans with the JAX test's smooth injected drift
  (growing as (k/(T−1))² to (0.5, −0.4, 3.0) m), ``lc_map_width=25``,
  radius 15 m, time threshold 10 s, ICP threshold 0.3: the candidates,
  each one's ICP pose, fitness and accepted flag, and the corrected chain;
  the spread of the corrected chain under ±1e-9 m (``nudge_dp``) and
  ±1e-5 m (``nudge_f32_dp``, the f32 resolution of the ~20 m world points)
  nudges of the drifted chain.
* ``dense_pcd_seed19.npz`` (``--only dense``) — ``interpolate_segments``
  on a ``dense_frames=3`` drive of 30 keyframes with 1024-point scans
  (keyframe poses: truth plus N(0, 0.05) m), and ``assemble_map`` +
  ``write_pcd`` at the default extrinsic and ``mapping_interval``: p and q
  of the dense frames, and the points the PCD file holds.

Each file stores its configuration and scenario. ``lc`` takes about a
minute, ``fusion`` about ten, the others a few:

    JAX_PLATFORMS=cpu python scripts/make_torch_stage3_fixture.py [--only NAME]

``stage3_spread`` is also used by the pipeline fixture scripts for the
stage-1 → stage-3 gains.
"""

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import os
import sys
import time
import unittest.mock

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from glio_tpu_torch.testing import (dense_episode, divergence_episode,  # noqa: E402
                                    loop_episode, reset_decisions)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
OUT = {"lc": "lc_T3493_seed4.npz", "fusion": "backend_fusion_w50_seed21.npz",
       "fusion_small": "backend_fusion_small_seed21.npz",
       "loop": "loop_closure_seed17.npz", "dense": "dense_pcd_seed19.npz"}

LC = dict(n_keyframes=3493, seed=4, psr_noise=0.5, epoch_stride=3, max_drift=6.0,
          nudge_m=1e-9, nudge_psr_m=1e-8)
FUSION = dict(n_keyframes=48, scan_points=1024, seed=21, every=8, fusion_span=48,
              imu_bias_frames=[12, 22], imu_bias=[1.5, 0.0, 0.0], blind_frames=[12, 26],
              epoch_stride=1, drift_thr=20.0, fix_gate=8.0, nudge_m=1e-9)
LOOP = dict(n_keyframes=132, lap_keyframes=66, scan_points=1024, seed=17,
            drift=[0.5, -0.4, 3.0], lc_search_radius=15.0, lc_time_thres=10.0,
            lc_map_width=25, lc_icp_thres=0.3, nudge_m=1e-9, nudge_f32_m=1e-5)
DENSE = dict(n_keyframes=30, scan_points=1024, seed=19, dense_frames=3, dense_noise=0.005,
             pose_noise=0.05, pose_seed=4)


def _jax_cpu():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def _cfg_json(cfg):
    return np.array(json.dumps(dataclasses.asdict(cfg)))


def bench_config(**estimator):
    from glio_tpu.config import EstimatorConfig, GlioConfig, ShapeConfig
    return GlioConfig().replace(
        shapes=ShapeConfig(max_imu_per_interval=40, scan_points=1024, map_points=16384),
        estimator=EstimatorConfig(local_map_width=50, sw_max_iter=15, **estimator))


# --- stage 3 ---------------------------------------------------------------------

def jax_stage3(cfg, kf_time, gnss, p_sw, q_sw, anchor, yaw, station):
    """``glio_tpu.pipeline``'s stage-3 branch (:557-591), with its
    intermediate arrays: a dict of numpy arrays."""
    import jax.numpy as jnp
    from glio_tpu.eval import trajectory as traj
    from glio_tpu.gnss import rtk
    from glio_tpu.models import lc_fusion
    from glio_tpu.utils import coords as C
    g = gnss
    fixes, covs, oks, _ = rtk.solve_epochs_dd(
        jnp.asarray(g.sat_pos), jnp.asarray(g.psr_rov), jnp.asarray(g.psr_sta),
        jnp.asarray(g.valid), jnp.asarray(g.system, jnp.int32), jnp.asarray(g.master),
        jnp.asarray(station), jnp.asarray(g.elevation), jnp.asarray(g.snr), jnp.asarray(anchor),
        huber=cfg.estimator.rtk_fix_huber, trim=cfg.estimator.rtk_fix_trim)
    fixes = np.asarray(fixes)
    sig = np.sqrt(np.maximum(np.trace(np.asarray(covs), axis1=1, axis2=2) / 3.0, 1e-6))
    okn = np.asarray(oks) & (sig < cfg.estimator.gnss_cov_threshold)
    ia, ib = traj.associate(kf_time, g.time, max_dt=0.2)
    gnss_p = np.zeros_like(p_sw)
    gnss_valid = np.zeros(p_sw.shape[0], bool)
    gnss_sigma = np.ones(p_sw.shape[0])
    enu_fix = np.asarray(C.ecef2enu(jnp.asarray(fixes), jnp.asarray(anchor)))
    sy, cy = np.sin(yaw), np.cos(yaw)
    RzT = np.array([[cy, sy, 0], [-sy, cy, 0], [0, 0, 1.0]])
    for a, b in zip(ia, ib):
        if okn[b]:
            gnss_p[a] = enu_fix[b] @ RzT.T
            gnss_valid[a] = True
            gnss_sigma[a] = sig[b]
    prob = lc_fusion.build_problem(p_sw, q_sw, gnss_p, gnss_valid, gnss_sigma)
    p_l, q_l, cost = lc_fusion.solve(prob, jnp.asarray(p_sw), jnp.asarray(q_sw))
    return dict(fixes=fixes, ok=np.asarray(oks), sig=sig, okn=okn, gnss_p=gnss_p,
                gnss_valid=np.asarray(prob.gnss_valid), p_lc=np.asarray(p_l),
                q_lc=np.asarray(q_l), cost=np.asarray(cost))


def ypr_deg(q):
    from glio_tpu.utils import quat
    return np.rad2deg(np.asarray(quat.to_ypr(np.asarray(q))))


def ypr_diff_deg(a, b):
    return float(np.abs((a - b + 180.0) % 360.0 - 180.0).max())


def stage3_spread(cfg, ep, p_sw, q_sw, anchor, yaw, station, nudge_m=1e-9):
    """JAX's own stage-3 spread around the stage-1 chain (p_sw, q_sw): how
    far p_lc and its yaw/pitch/roll move under a ±``nudge_m`` nudge of p_sw
    (``lc_nudge_dp`` m, ``lc_nudge_ypr`` deg); per metre of the largest move
    of p_sw by 1e-3 m x N(0, 1) (``lc_gain_p_per_m``, ``lc_gain_ypr_per_m``);
    and per degree of the largest yaw/pitch/roll move of q_sw turned by
    1e-4 rad x N(0, 1) per axis (``lc_gain_p_per_deg``,
    ``lc_gain_ypr_per_deg``). Gains: the larger of two seeds."""
    from glio_tpu.utils import quat
    ref = jax_stage3(cfg, ep.kf_time, ep.gnss, p_sw, q_sw, anchor, yaw, station)
    ypr_ref = ypr_deg(ref["q_lc"])

    def moved(p, q=q_sw):
        r = jax_stage3(cfg, ep.kf_time, ep.gnss, p, q, anchor, yaw, station)
        return np.abs(r["p_lc"] - ref["p_lc"]).max(), ypr_diff_deg(ypr_deg(r["q_lc"]), ypr_ref)

    nudged = [moved(p_sw + s * nudge_m) for s in (1.0, -1.0)]
    gains, gains_q = [], []
    for seed in (1, 2):
        rng = np.random.default_rng(seed)
        d = 1e-3 * rng.normal(size=p_sw.shape)
        dp, dypr = moved(p_sw + d)
        gains.append((dp / np.abs(d).max(), dypr / np.abs(d).max()))
        q2 = np.asarray(quat.normalize(quat.mul(q_sw, quat.exp(1e-4 * rng.normal(
            size=p_sw.shape)))))
        turn = ypr_diff_deg(ypr_deg(q2), ypr_deg(q_sw))
        dp, dypr = moved(p_sw, q2)
        gains_q.append((dp / turn, dypr / turn))
    return {"lc_nudge_dp": np.array(max(m[0] for m in nudged)),
            "lc_nudge_ypr": np.array(max(m[1] for m in nudged)),
            "lc_gain_p_per_m": np.array(max(g[0] for g in gains)),
            "lc_gain_ypr_per_m": np.array(max(g[1] for g in gains)),
            "lc_gain_p_per_deg": np.array(max(g[0] for g in gains_q)),
            "lc_gain_ypr_per_deg": np.array(max(g[1] for g in gains_q))}


def make_lc() -> dict:
    _jax_cpu()
    from glio_tpu.config import GlioConfig
    from glio_tpu.data.simulator import simulate_gnss_epochs
    from glio_tpu_torch.data.simulator import drifted_trajectory
    cfg = GlioConfig()
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    kf_time, p_true, q_true, p_odo = drifted_trajectory(LC["n_keyframes"], LC["max_drift"])
    g = simulate_gnss_epochs(p_true, kf_time, anchor, station, psr_noise=LC["psr_noise"],
                             epoch_stride=LC["epoch_stride"], seed=LC["seed"])
    t0 = time.perf_counter()
    out = jax_stage3(cfg, kf_time, g, p_odo, q_true, anchor, 0.0, station)
    print(f"stage 3 T={LC['n_keyframes']}: {time.perf_counter() - t0:.1f} s, "
          f"{int(out['ok'].sum())} of {len(out['ok'])} fixes ok, "
          f"{int(out['gnss_valid'].sum())} factors", flush=True)
    dfix, dfp, dfq, dp, dq = [], [], [], [], []
    for s in (1.0, -1.0):
        sign = s * (-1.0) ** np.arange(g.psr_rov.shape[1])
        g_n = dataclasses.replace(g, psr_rov=g.psr_rov + LC["nudge_psr_m"] * sign * g.valid)
        r = jax_stage3(cfg, kf_time, g_n, p_odo, q_true, anchor, 0.0, station)
        dfix.append(np.abs(r["fixes"] - out["fixes"])[out["ok"]].max())
        dfp.append(np.abs(r["p_lc"] - out["p_lc"]).max())
        dfq.append(np.abs(r["q_lc"] - out["q_lc"]).max())
        r = jax_stage3(cfg, kf_time, g, p_odo + s * LC["nudge_m"], q_true, anchor, 0.0, station)
        dp.append(np.abs(r["p_lc"] - out["p_lc"]).max())
        dq.append(np.abs(r["q_lc"] - out["q_lc"]).max())
    out.update(nudge_fix=np.array(max(dfix)), nudge_fix_dp=np.array(max(dfp)),
               nudge_fix_dq=np.array(max(dfq)), nudge_dp=np.array(max(dp)),
               nudge_dq=np.array(max(dq)),
               rmse_odo=np.array(np.sqrt(np.mean(np.sum((p_odo - p_true) ** 2, -1)))),
               rmse_lc=np.array(np.sqrt(np.mean(np.sum((out["p_lc"] - p_true) ** 2, -1)))),
               config_json=_cfg_json(cfg), scenario_json=np.array(json.dumps(LC)))
    print(f"nudges: pseudoranges move the fixes {out['nudge_fix']:.3e} m, p_lc "
          f"{out['nudge_fix_dp']:.3e} m, q_lc {out['nudge_fix_dq']:.3e}; the odometry moves "
          f"p_lc {out['nudge_dp']:.3e} m, q_lc {out['nudge_dq']:.3e}; RMSE odometry {float(out['rmse_odo']):.4f} m, LC "
          f"{float(out['rmse_lc']):.4f} m", flush=True)
    return out


# --- backend fusion ----------------------------------------------------------------

def _jax_fusion_run(cfg, ep, sc, p0_nudge=0.0):
    from glio_tpu.models import batch as B
    from glio_tpu.pipeline import replay_with_backend_fusion
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    ep = dataclasses.replace(ep, p0=ep.p0 + p0_nudge)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), unittest.mock.patch.object(
            B, "optimize_batch", functools.partial(B.optimize_batch, mixed=False)):
        p, q = replay_with_backend_fusion(cfg, ep, ep.to_inputs(), anchor, 0.0, station,
                                          every=sc["every"], fusion_span=sc["fusion_span"],
                                          debug=True)
    return p, q, buf.getvalue().splitlines()


def make_fusion(sc, cfg, arms) -> dict:
    """The scenario under each (tag, cfg) of ``arms``; nudges of the first."""
    _jax_cpu()
    from glio_tpu.data.simulator import simulate_episode, simulate_gnss_epochs
    ep = divergence_episode(sc, simulate_episode)
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    ep.gnss = simulate_gnss_epochs(ep.gt_p, ep.kf_time, anchor, station, psr_noise=0.5,
                                   epoch_stride=sc["epoch_stride"], seed=sc["seed"])
    out = {}
    for tag, arm_cfg in arms:
        t0 = time.perf_counter()
        p, q, lines = _jax_fusion_run(arm_cfg, ep, sc)
        err = np.linalg.norm(p - ep.gt_p, axis=-1)
        print(f"{tag}: {time.perf_counter() - t0:.1f} s; resets {reset_decisions(lines)}; error "
              f"last 8 mean {err[-8:].mean():.2f} m, min {err[-8:].min():.2f} m", flush=True)
        out.update({f"p_{tag}": p, f"q_{tag}": q,
                    f"lines_{tag}": np.array(json.dumps(lines)),
                    f"config_json_{tag}": _cfg_json(arm_cfg)})
    tag, arm_cfg = arms[0]
    dps, stable = [], True
    for s in (1.0, -1.0):
        p, _, lines = _jax_fusion_run(arm_cfg, ep, sc, s * sc["nudge_m"])
        dps.append(np.abs(p - out[f"p_{tag}"]).max())
        stable &= reset_decisions(lines) == reset_decisions(json.loads(str(out[f"lines_{tag}"])))
        print(f"nudge {s:+.0f}e-9 m: resets {reset_decisions(lines)}, p moves {dps[-1]:.3e} m",
              flush=True)
    out["nudge_dp"] = np.array(max(dps))
    out["decisions_stable"] = np.array(bool(stable))
    out["gt_p"] = ep.gt_p
    out["scenario_json"] = np.array(json.dumps(sc))
    return out


def small_fusion_config(drift_thr, fix_gate):
    from glio_tpu.config import EstimatorConfig, GlioConfig, ShapeConfig
    return GlioConfig().replace(
        shapes=ShapeConfig(max_imu_per_interval=40, scan_points=256, map_points=4096),
        estimator=EstimatorConfig(local_map_width=8, sw_max_iter=8,
                                  reset_drift_threshold=drift_thr,
                                  reset_fix_disagree=fix_gate))


# --- loop closure ------------------------------------------------------------------

def loop_config():
    return bench_config(loop_closure_on=True, lc_search_radius=LOOP["lc_search_radius"],
                        lc_time_thres=LOOP["lc_time_thres"], lc_map_width=LOOP["lc_map_width"],
                        lc_icp_thres=LOOP["lc_icp_thres"])


def make_loop() -> dict:
    _jax_cpu()
    import jax.numpy as jnp
    from glio_tpu.data.simulator import simulate_episode
    from glio_tpu.models import loop_closure as L
    from glio_tpu.pipeline import apply_loop_closure
    cfg = loop_config()
    est = cfg.estimator
    ep, p_drift = loop_episode(LOOP, simulate_episode)
    q = ep.gt_q
    cands = L.detect_loops(p_drift, ep.kf_time, search_radius=est.lc_search_radius,
                           time_thresh=est.lc_time_thres)
    w = max(est.lc_map_width // 2, 1)
    T = p_drift.shape[0]
    icp = []
    t0 = time.perf_counter()
    for c in cands:
        j0, j1 = max(c.old - w, 0), min(c.old + w + 1, T)
        p_c, q_c, fit, ok = L.verify_loop(cfg, ep.scan[c.cur], ep.scan_valid[c.cur],
                                          ep.scan[j0:j1], ep.scan_valid[j0:j1], p_drift[j0:j1],
                                          q[j0:j1], p_drift[c.cur], q[c.cur])
        icp.append((np.asarray(p_c), np.asarray(q_c), float(fit), bool(ok), j1 - j0))
    p, q_out, n_edges = apply_loop_closure(cfg, ep, p_drift, q)
    print(f"loop closure: {len(cands)} candidates {[tuple(c) for c in cands]}, accepted "
          f"{[i[3] for i in icp]}, fitness {[round(i[2], 4) for i in icp]}, map scans "
          f"{[i[4] for i in icp]}; {n_edges} edges; {time.perf_counter() - t0:.1f} s", flush=True)
    spreads = {}
    for key, m in (("nudge_dp", LOOP["nudge_m"]), ("nudge_f32_dp", LOOP["nudge_f32_m"])):
        d = []
        for s in (1.0, -1.0):
            p_n, _, n_n = apply_loop_closure(cfg, ep, p_drift + s * m, q)
            d.append(np.abs(np.asarray(p_n) - np.asarray(p)).max() if n_n == n_edges
                     else np.inf)
        spreads[key] = np.array(max(d))
        print(f"{key}: {float(spreads[key]):.3e} m", flush=True)
    g_true = ep.gt_p[-1] - ep.gt_p[0]
    return {"cands": np.array([tuple(c) for c in cands], np.int64).reshape(-1, 2),
            "icp_p": np.array([i[0] for i in icp]), "icp_q": np.array([i[1] for i in icp]),
            "icp_fitness": np.array([i[2] for i in icp]),
            "icp_accepted": np.array([i[3] for i in icp]),
            "p": np.asarray(p), "q": np.asarray(q_out), "n_edges": np.array(n_edges),
            "z_before": np.array(abs((p_drift[-1] - p_drift[0])[2] - g_true[2])),
            "z_after": np.array(abs((np.asarray(p)[-1] - np.asarray(p)[0])[2] - g_true[2])),
            **spreads, "config_json": _cfg_json(cfg), "scenario_json": np.array(json.dumps(LOOP))}


# --- dense frames and the map export ---------------------------------------------

def make_dense() -> dict:
    _jax_cpu()
    import tempfile

    import jax.numpy as jnp
    from glio_tpu.config import GlioConfig
    from glio_tpu.data.simulator import simulate_episode
    from glio_tpu.eval import pointcloud
    from glio_tpu.models import local_graph
    cfg = GlioConfig()
    est = cfg.estimator
    ep, kf_p = dense_episode(DENSE, simulate_episode)
    p_d, q_d, v_d = local_graph.interpolate_segments(
        jnp.asarray(kf_p), jnp.asarray(ep.gt_q), jnp.asarray(ep.dense_rel_dp),
        jnp.asarray(ep.dense_rel_dq), jnp.asarray(ep.dense_rel_valid),
        max_dense=DENSE["dense_frames"])
    world, valid = pointcloud.assemble_map(ep.scan, ep.scan_valid, kf_p, ep.gt_q,
                                           every=max(est.mapping_interval, 1),
                                           ql2b=est.ql2b, tl2b=est.tl2b)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.pcd")
        n = pointcloud.write_pcd(path, world, valid)
        pcd = pointcloud.read_pcd(path)
    print(f"dense: {tuple(np.asarray(p_d).shape)} frames; map {n} points", flush=True)
    return {"p_dense": np.asarray(p_d), "q_dense": np.asarray(q_d),
            "dense_valid": np.asarray(v_d), "pcd_points": pcd,
            "world_checksum": np.array([np.asarray(world).sum(), (np.asarray(world) ** 2).sum()]),
            "config_json": _cfg_json(cfg), "scenario_json": np.array(json.dumps(DENSE))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=sorted(OUT))
    ap.add_argument("--fusion-keyframes", type=int, default=FUSION["n_keyframes"])
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    makers = {
        "lc": make_lc,
        "fusion": lambda: make_fusion(
            dict(FUSION, n_keyframes=args.fusion_keyframes),
            bench_config(), [("gated", bench_config(reset_drift_threshold=FUSION["drift_thr"],
                                                    reset_fix_disagree=FUSION["fix_gate"]))]),
        "fusion_small": lambda: make_fusion(
            dict(FUSION, scan_points=256), small_fusion_config(20.0, 8.0),
            [("gated", small_fusion_config(20.0, 8.0)), ("off", small_fusion_config(1e9, 1e9))]),
        "loop": make_loop,
        "dense": make_dense,
    }
    for name in ([args.only] if args.only else list(OUT)):
        t0 = time.perf_counter()
        fx = makers[name]()
        path = os.path.join(DATA, OUT[name])
        np.savez_compressed(path, **fx)
        print(f"wrote {path} ({os.path.getsize(path)} B) in {time.perf_counter() - t0:.1f} s",
              flush=True)


if __name__ == "__main__":
    main()
