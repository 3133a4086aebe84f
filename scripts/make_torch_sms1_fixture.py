"""JAX fixtures for the PyTorch port's batch level 1 on the card.

Runs ``glio_tpu`` on the CPU and writes two files that ``chip_smoke.py``
holds the port against (the card has no jax):

* ``tests/data/sms1_T3493_seed4.npz`` — batch level 1
  (``sms_fusion_level=1``: binary scan-to-multiscan planes, relative
  attitude, DD pseudoranges and IMU chains over 15-dof keyframe states) at
  the length of the UrbanNav Whampoa sequence, following
  ``scripts/bench_sms1.py``: ``simulate_episode(n_keyframes=3493,
  scan_points=1024, seed=4)``, simulated GNSS every third keyframe
  (``psr_noise=0.5, seed=4``), an odometry of ground truth plus a random
  walk of N(0, 0.05) m steps plus 0.05 m noise (``default_rng(4)``), the
  default ``GlioConfig`` with ``sms_fusion_level=1``; then
  ``build_problem``, ``build_sms1`` at the odometry poses,
  ``build_imu_chain`` and ``optimize_batch_sms1_imu`` (4 stages x 6 LM
  iterations, ``solver="direct"``) in both precisions (``mixed=False``, the
  port's arithmetic, and ``mixed=True``, the JAX main path). Stored:
  checksums of the episode and the problem; the association's mask as
  packed bits, its count and the sum of the scores of each (keyframe,
  offset), and the index in scan i of the point each slot holds
  (``sel_idx``, 0xFFFF where the slot is empty; 0.75 MB of the file's
  1.7); p, q, v, ba, bg and the per-stage costs of the f64 solve, p, q and
  the costs of the mixed one; and JAX's own spread, the spread the port's
  tolerances are set from: how far the f64 result's p, q and v move when
  the odometry is nudged by ±1e-9 m, associated and solved again
  (``nudge_dp``, ``nudge_dq``, ``nudge_dv``), and how many slots the nudge
  empties or fills (``nudge_mask_differ``) or gives another point
  (``nudge_sel_differ``); and JAX with the port's one change to the plane
  fit, its 3x3 eigensystem evaluated in f64 and cast back
  (``fit_planes_f64_eigensystem``), associated and solved in f64: p, q and
  v (``*_f64eig``) and how many slots that gives another point
  (``f64eig_sel_differ``) or empties or fills (``f64eig_mask_differ``).
* ``tests/data/pipeline_sms1_seed0.npz`` — ``run_pipeline`` (stages 1-3)
  with ``sms_fusion_level=1`` at the ``bench.py`` shapes on
  ``simulate_episode(n_keyframes=15, seed=0)`` with GNSS at every keyframe:
  the rows of ``tc_sw_result.csv``, ``tc_batch_result.csv`` and
  ``lc_result.csv`` (with stage 3's spread and gain, the ``lc_*`` keys of
  ``scripts/make_torch_stage3_fixture.py::stage3_spread``), with the
  level-1 batch solve in mixed precision (the JAX main path) and in f64
  (``*_f64`` keys); how far the f64 batch's positions and yaw/pitch/roll
  move when stage 2 is run again from the stage-1 trajectory nudged by
  ±1e-9 m (``nudge_dp`` m, ``nudge_ypr`` deg); and how much a difference
  in stage 1 grows through the level-1 batch, which re-associates at the
  stage-1 poses: stage-1 positions moved by 1e-3 m x N(0, 1) move the
  batch's positions ``gain_p_per_m`` m and its yaw/pitch/roll
  ``gain_ypr_per_m`` deg per metre of the largest move (the larger of two
  seeds). ``chip_smoke.py`` carries the port's measured stage-1 difference
  through these gains.

Each file stores the configuration and the scenario it was made with.
Takes about thirty minutes on the CPU:

    JAX_PLATFORMS=cpu python scripts/make_torch_sms1_fixture.py [--keyframes N] [--only sms1|pipeline]

``--keyframes`` makes a shorter level-1 fixture (a trial run; the card
phase expects 3493); ``--only`` makes one of the two files.
"""

import argparse
import dataclasses
import functools
import json
import os
import sys
import tempfile
import time
import unittest.mock

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMS1_OUT = os.path.join(ROOT, "tests", "data", "sms1_T3493_seed4.npz")
PIPE_OUT = os.path.join(ROOT, "tests", "data", "pipeline_sms1_seed0.npz")

SMS1 = dict(n_keyframes=3493, scan_points=1024, seed=4, psr_noise=0.5, epoch_stride=3,
            drift_step=0.05, odo_noise=0.05, lm_iters=6, nudge_m=1e-9)
THRESHOLDS = (1e9, 10.0, 8.0, 6.0)
PIPE = dict(n_keyframes=15, scan_points=1024, seed=0, gnss_seed=0, epoch_stride=1)
CSV_NAMES = ("tc_sw_result.csv", "tc_batch_result.csv", "lc_result.csv")


def checksums(*arrays):
    """(n, 2): sum and sum of squares of each array, f64."""
    out = []
    for a in arrays:
        a = np.asarray(a, np.float64)
        out.append([a.sum(), (a * a).sum()])
    return np.array(out)


def sms1_config(base=None):
    from glio_tpu.config import GlioConfig
    cfg = GlioConfig() if base is None else base
    return cfg.replace(estimator=dataclasses.replace(cfg.estimator, sms_fusion_level=1))


def _jax_cpu():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def make_sms1_fixture(n_keyframes: int) -> dict:
    _jax_cpu()
    from glio_tpu.data.simulator import simulate_episode, simulate_gnss_epochs
    from glio_tpu.models import batch as B
    from glio_tpu_torch.data.simulator import random_walk_odometry
    from glio_tpu_torch.testing import selected_indices

    sc = dict(SMS1, n_keyframes=n_keyframes)
    cfg = sms1_config()
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    t0 = time.perf_counter()
    ep = simulate_episode(n_keyframes=sc["n_keyframes"], scan_points=sc["scan_points"],
                          seed=sc["seed"])
    gnss = simulate_gnss_epochs(ep.gt_p, ep.kf_time, anchor, station,
                                psr_noise=sc["psr_noise"], epoch_stride=sc["epoch_stride"],
                                seed=sc["seed"])
    p_odo = random_walk_odometry(ep.gt_p, sc["seed"], sc["drift_step"], sc["odo_noise"])
    q_odo = np.asarray(ep.gt_q)
    prob = B.build_problem(cfg, p_odo, q_odo, ep.kf_time, gnss, anchor, 0.0, station)
    print(f"simulated and built T={n_keyframes} in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    sms = B.build_sms1(cfg, ep.scan, ep.scan_valid, p_odo, q_odo)
    mask = np.asarray(sms.mask)
    print(f"build_sms1: {time.perf_counter() - t0:.1f} s, {int(mask.sum())} slots", flush=True)
    chain = B.build_imu_chain(cfg, ep.imu_acc, ep.imu_gyr, ep.imu_dt, ep.imu_valid)

    out = {}
    for tag, mixed in (("f64", False), ("mixed", True)):
        t0 = time.perf_counter()
        p, q, v, ba, bg, costs = B.optimize_batch_sms1_imu(
            cfg, prob, sms, chain, thresholds=THRESHOLDS, lm_iters=sc["lm_iters"],
            solver="direct", mixed=mixed)
        print(f"solve {tag}: {time.perf_counter() - t0:.1f} s, costs {costs}", flush=True)
        out[f"p_{tag}"] = np.asarray(p)
        out[f"q_{tag}"] = np.asarray(q)
        out[f"costs_{tag}"] = np.asarray(costs)
        if not mixed:
            out["v_f64"], out["ba_f64"], out["bg_f64"] = (np.asarray(a) for a in (v, ba, bg))
    # JAX's own spread: the odometry nudged by ±1e-9 m, associated and
    # solved again. The nudge flips the f32 rounding of some world points,
    # which reorders near-ties of the top-25 selection as the port's f64
    # eigensystem does.
    pts = np.asarray(sms.pts_i)
    spread = {"dp": [], "dq": [], "dv": [], "mask_differ": [], "sel_differ": []}
    for sign in (1.0, -1.0):
        p_n = p_odo + sign * sc["nudge_m"]
        prob_n = B.build_problem(cfg, p_n, q_odo, ep.kf_time, gnss, anchor, 0.0, station)
        sms_n = B.build_sms1(cfg, ep.scan, ep.scan_valid, p_n, q_odo)
        spread["mask_differ"].append(int((np.asarray(sms_n.mask) != mask).sum()))
        spread["sel_differ"].append(int((np.any(np.asarray(sms_n.pts_i) != pts, -1)
                                         & mask).sum()))
        p_s, q_s, v_s = B.optimize_batch_sms1_imu(
            cfg, prob_n, sms_n, chain, thresholds=THRESHOLDS, lm_iters=sc["lm_iters"],
            solver="direct", mixed=False)[:3]
        for key, a in (("dp", p_s), ("dq", q_s), ("dv", v_s)):
            spread[key].append(np.abs(np.asarray(a) - out[f"{key[1]}_f64"]).max())
        print(f"nudge {sign:+.0f}e-9 m: {spread['mask_differ'][-1]} masks and "
              f"{spread['sel_differ'][-1]} selected points differ; p moves "
              f"{spread['dp'][-1]:.3e} m, q {spread['dq'][-1]:.3e}, v "
              f"{spread['dv'][-1]:.3e} m/s", flush=True)
    for key, values in spread.items():
        out[f"nudge_{key}"] = np.array(max(values))
    # JAX with the eigensystem of its plane fits in f64, as the port has it.
    from glio_tpu.lidar import plane_fit
    with unittest.mock.patch.object(plane_fit, "fit_planes_centroid", fit_planes_f64_eigensystem):
        sms_e = B.build_sms1(cfg, ep.scan, ep.scan_valid, p_odo, q_odo)
    out["f64eig_mask_differ"] = np.array(int((np.asarray(sms_e.mask) != mask).sum()))
    out["f64eig_sel_differ"] = np.array(int((np.any(np.asarray(sms_e.pts_i) != pts, -1)
                                             & mask).sum()))
    p_e, q_e, v_e = B.optimize_batch_sms1_imu(cfg, prob, sms_e, chain, thresholds=THRESHOLDS,
                                              lm_iters=sc["lm_iters"], solver="direct",
                                              mixed=False)[:3]
    out["p_f64eig"], out["q_f64eig"], out["v_f64eig"] = (np.asarray(a) for a in (p_e, q_e, v_e))
    print(f"eigensystem in f64: {int(out['f64eig_mask_differ'])} masks and "
          f"{int(out['f64eig_sel_differ'])} selected points differ; p moves "
          f"{np.abs(out['p_f64eig'] - out['p_f64']).max():.3e} m", flush=True)

    score = np.asarray(sms.score)
    out["sel_idx"] = selected_indices(ep.scan, pts, mask)
    out["mask_bits"] = np.packbits(mask.reshape(-1))
    out["mask_count"] = mask.sum(-1).astype(np.int16)               # (T, R)
    out["score_sum"] = np.where(mask, score, 0.0).sum(-1)          # (T, R)
    out["episode_checksums"] = checksums(ep.scan, ep.scan_valid, ep.imu_acc, ep.imu_gyr,
                                         ep.imu_dt, ep.gt_p, ep.gt_q, ep.gt_v)
    out["problem_checksums"] = checksums(prob.p_odo, prob.psr_rov, prob.whiten,
                                         prob.ep_valid, prob.rel_dq)
    out["rmse_odo"] = np.array(np.sqrt(np.mean(np.sum((p_odo - ep.gt_p) ** 2, -1))))
    out["config_json"] = np.array(json.dumps(dataclasses.asdict(cfg)))
    out["scenario_json"] = np.array(json.dumps(
        {**sc, "thresholds": THRESHOLDS, "solver": "direct"}))
    return out


def fit_planes_f64_eigensystem(neigh, neigh_valid, min_planarity: float = 0.0):
    """``glio_tpu.lidar.plane_fit.fit_planes_centroid`` with its 3x3
    eigensystem evaluated in f64 and cast back, as the port evaluates it;
    centroid and scatter matrix in the points' f32 as there."""
    import jax.numpy as jnp
    dtype = neigh.dtype
    m = neigh_valid.astype(dtype)[..., None]
    cnt = jnp.maximum(jnp.sum(m, axis=-2), 1.0)
    cent = jnp.sum(neigh * m, axis=-2) / cnt
    dcent = (neigh - cent[..., None, :]) * m
    cov = jnp.einsum("qki,qkj->qij", dcent, dcent) / cnt[..., None]
    w, V = jnp.linalg.eigh(cov.astype(jnp.float64))
    w, normal = w.astype(dtype), V[..., :, 0].astype(dtype)
    tr = jnp.sum(w, axis=-1)
    planarity = 1.0 - 3.0 * w[..., 0] / jnp.maximum(tr, 1e-12)
    valid = (cnt[..., 0] >= 3) & (planarity >= min_planarity)
    return normal, cent, planarity, valid


def ypr_deg(q):
    """Yaw, pitch, roll in degrees, as the result CSVs write them."""
    from glio_tpu.utils import quat
    return np.rad2deg(np.asarray(quat.to_ypr(np.asarray(q))))


def ypr_diff_deg(a, b):
    """Largest |a - b| of two yaw/pitch/roll arrays, in degrees, across ±180."""
    return float(np.abs((a - b + 180.0) % 360.0 - 180.0).max())


def read_csv_rows(path):
    return np.loadtxt(path, delimiter=",", ndmin=2)


def pipeline_config():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from make_torch_port_fixture import config
    return sms1_config(config())


def make_pipeline_fixture() -> dict:
    _jax_cpu()
    from glio_tpu.data.simulator import simulate_episode, simulate_gnss_epochs
    from glio_tpu.models import batch as B
    from glio_tpu.pipeline import run_pipeline

    cfg = pipeline_config()
    ep = simulate_episode(n_keyframes=PIPE["n_keyframes"],
                          scan_points=PIPE["scan_points"], seed=PIPE["seed"])
    anchor = np.asarray(cfg.initialization.anc_ecef)
    ep.gnss = simulate_gnss_epochs(ep.gt_p, ep.kf_time, anchor,
                                   np.asarray(cfg.initialization.station_ecef),
                                   epoch_stride=PIPE["epoch_stride"], seed=PIPE["gnss_seed"])
    ep.anchor_ecef = anchor
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        res0 = run_pipeline(ep, cfg, out_dir=tmp)
        for name in CSV_NAMES:
            out[name.replace(".csv", "")] = read_csv_rows(os.path.join(tmp, name))
    f64_solve = functools.partial(B.optimize_batch_sms1_imu, mixed=False)
    with tempfile.TemporaryDirectory() as tmp, \
            unittest.mock.patch.object(B, "optimize_batch_sms1_imu", f64_solve):
        res = run_pipeline(ep, cfg, out_dir=tmp, run_lc=False)
        out["tc_batch_result_f64"] = read_csv_rows(os.path.join(tmp, "tc_batch_result.csv"))
    # JAX's own spread: stage 2 again (associated and solved again, in f64)
    # from the stage-1 trajectory nudged by ±1e-9 m; and the gains from a
    # stage-1 difference to the batch's (module docstring).
    station = np.asarray(cfg.initialization.station_ecef)
    chain = B.build_imu_chain(cfg, ep.imu_acc, ep.imu_gyr, ep.imu_dt, ep.imu_valid)
    ypr_batch = ypr_deg(res.q_batch)

    def moved(p_sw, q_sw):
        """(max |Δp| m, max |Δypr| deg) of the f64 level-1 batch from (p_sw, q_sw)."""
        prob = B.build_problem(cfg, p_sw, q_sw, ep.kf_time, ep.gnss, anchor, 0.0, station)
        sms = B.build_sms1(cfg, ep.scan, ep.scan_valid, p_sw, q_sw)
        p_b, q_b = B.optimize_batch_sms1_imu(cfg, prob, sms, chain, mixed=False)[:2]
        return (np.abs(np.asarray(p_b) - np.asarray(res.p_batch)).max(),
                ypr_diff_deg(ypr_deg(q_b), ypr_batch))

    nudged = [moved(res.p_sw + sign * SMS1["nudge_m"], res.q_sw) for sign in (1.0, -1.0)]
    out["nudge_dp"] = np.array(max(m[0] for m in nudged))
    out["nudge_ypr"] = np.array(max(m[1] for m in nudged))
    gains = []
    for seed in (1, 2):
        d = 1e-3 * np.random.default_rng(seed).normal(size=res.p_sw.shape)
        dp, dypr = moved(res.p_sw + d, res.q_sw)
        gains.append((dp / np.abs(d).max(), dypr / np.abs(d).max()))
    out["gain_p_per_m"] = np.array(max(g[0] for g in gains))
    out["gain_ypr_per_m"] = np.array(max(g[1] for g in gains))
    from make_torch_stage3_fixture import stage3_spread
    out.update(stage3_spread(cfg, ep, res0.p_sw, res0.q_sw, anchor, 0.0, station))
    out["config_json"] = np.array(json.dumps(dataclasses.asdict(cfg)))
    out["scenario_json"] = np.array(json.dumps(PIPE))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keyframes", type=int, default=SMS1["n_keyframes"])
    ap.add_argument("--only", choices=("sms1", "pipeline"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    os.makedirs(os.path.dirname(SMS1_OUT), exist_ok=True)
    if args.only != "pipeline":
        make_sms1_file(args.keyframes)
    if args.only != "sms1":
        fx = make_pipeline_fixture()
        np.savez_compressed(PIPE_OUT, **fx)
        gap = np.abs(fx["tc_batch_result"][:, 9:12] - fx["tc_batch_result_f64"][:, 9:12]).max()
        print(f"wrote {PIPE_OUT}: batch ENU, mixed vs f64: max {gap:.3e} m; a 1e-9 m nudge "
              f"of stage 1 moves the f64 batch by {float(fx['nudge_dp']):.3e} m, "
              f"{float(fx['nudge_ypr']):.3e} deg; a stage-1 move of 1 m moves it "
              f"{float(fx['gain_p_per_m']):.2f} m, {float(fx['gain_ypr_per_m']):.3f} deg")


def make_sms1_file(n_keyframes):
    fx = make_sms1_fixture(n_keyframes)
    path = SMS1_OUT if n_keyframes == SMS1["n_keyframes"] else \
        SMS1_OUT.replace("T3493", f"T{n_keyframes}")
    np.savez_compressed(path, **fx)
    gap = np.abs(fx["p_f64"] - fx["p_mixed"]).max()
    print(f"wrote {path}: costs f64 {fx['costs_f64'].tolist()}, mixed "
          f"{fx['costs_mixed'].tolist()}; max |p_mixed - p_f64| {gap:.3e} m; "
          f"±1e-9 m nudge moves p_f64 by {float(fx['nudge_dp']):.3e} m, q by "
          f"{float(fx['nudge_dq']):.3e}, v by {float(fx['nudge_dv']):.3e} m/s and gives "
          f"{int(fx['nudge_sel_differ'])} slots another point")


if __name__ == "__main__":
    main()
