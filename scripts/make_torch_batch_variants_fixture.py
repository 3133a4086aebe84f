"""JAX fixtures for the PyTorch port's batch variants on the card
(``chip_smoke.py`` phases 16 and 17).

Runs ``glio_tpu`` on the CPU in f64 (``mixed=False``, the port's arithmetic;
the inner solves of the cadence and incremental modes patched to it) and writes,
under ``tests/data/``:

* ``batch_variants_T3493_seed4.npz`` (``--only atm``, ``--only incremental``,
  or both by default) — on the level-0 drive of ``batch_T3493_seed4.npz``
  (``scripts/make_torch_batch_fixture.py``: the 3493-keyframe drifted drive,
  simulated GNSS every third keyframe, the bench robust options):
  ``optimize_batch_atm`` (4 stages x 10 LM iterations) with the direct
  solver and with ``chol_pcg``: p, q, z and their spread under ±1e-9 m
  nudges of the odometry, uniform and of alternating sign across keyframes
  (``nudged_odometry``; ``atm_nudge_*``), for ``chol_pcg`` also under an
  f32-resolution rescaling of its preconditioner (``atm_f32_nudge_*``, as
  ``scripts/make_torch_gnss_fixture.py`` does for level 0); and
  ``optimize_batch_incremental`` at ``every=250`` with ``rederive`` (the
  JAX package's Whampoa A/B, batch.py:1445-1452; 4 LM iterations a stage):
  p, q and their spread under the odometry nudges (``incr_nudge_*``).
* ``batch_variants_cadence_T300_seed4.npz`` (``--only cadence``) —
  ``optimize_batch_reference_cadence`` at its own ``every=10`` on the first
  300 keyframes of that drive with GNSS simulated along them (the drive cut
  from 3493 keyframes to 300: 27 re-solves there, 347 at full length): p, q,
  the re-solve count and the spread under the odometry nudges.
* ``batch_variants_sms1_T3493_seed4.npz`` (``--only sms1``) — level 1's
  iterative solvers on the drive of ``sms1_T3493_seed4.npz``
  (``scripts/make_torch_sms1_fixture.py``), associated with the plane fits'
  eigensystem in f64 (``fit_planes_f64_eigensystem``, as the port computes
  it): ``optimize_batch_sms1`` and ``optimize_batch_sms1_imu`` with ``pcg``
  and ``chol_pcg`` (4 stages x 6 LM iterations): p, q (v) of each; their
  spread as phase 8 takes it, under ±1e-9 m nudges of the odometry (uniform
  and alternating) with JAX's own association, associated and solved again;
  and for ``chol_pcg`` under the preconditioner rescaling; the distance
  between JAX's results with its own association and with the f64
  eigensystem (``*_f32eig_d*``), which the gates absorb; and the checksums
  of the episode and the problem. ``--seed N`` makes the same file at
  another seed of the drive (``batch_variants_sms1_T3493_seedN.npz``), which
  ``scripts/check_torch_level1_solvers.py`` holds the port to on the card.

Each file stores its configuration and scenario. ``atm`` takes about 15
minutes, ``incremental`` 20, ``cadence`` 3, ``sms1`` about an hour and a half:

    JAX_PLATFORMS=cpu python scripts/make_torch_batch_variants_fixture.py [--only NAME] [--seed N]
"""

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import sys
import time
import unittest.mock

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from make_torch_batch_fixture import BATCH, THRESHOLDS, batch_scenario  # noqa: E402
from make_torch_sms1_fixture import (SMS1, checksums, fit_planes_f64_eigensystem,  # noqa: E402
                                     sms1_config)

DATA = os.path.join(ROOT, "tests", "data")
OUT = {"level0": os.path.join(DATA, "batch_variants_T3493_seed4.npz"),
       "cadence": os.path.join(DATA, "batch_variants_cadence_T300_seed4.npz"),
       "sms1": os.path.join(DATA, "batch_variants_sms1_T3493_seed{seed}.npz")}
VARIANTS = dict(atm_lm_iters=10, incr_every=250, incr_lm_iters=4, cadence_keyframes=300,
                cadence_every=10, nudge_m=1e-9)


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


@contextlib.contextmanager
def f64_inner_solves():
    """The JAX package's cadence and incremental modes with their inner
    solves in f64 (they call ``optimize_batch`` / ``solve_batch_once`` at the
    default ``mixed=True``)."""
    from glio_tpu.models import batch as JB
    solve = JB.solve_batch_once

    def solve_f64(*args, **kw):     # optimize_batch passes ``mixed`` as its tenth argument
        if len(args) < 10:
            kw.setdefault("mixed", False)
        return solve(*args, **kw)
    with unittest.mock.patch.object(JB, "optimize_batch",
                                    functools.partial(JB.optimize_batch, mixed=False)), \
            unittest.mock.patch.object(JB, "solve_batch_once", solve_f64):
        yield


@contextlib.contextmanager
def f32_rescaled(sign):
    """``chol_pcg``'s preconditioner from the equilibration scaled by
    1 ± 2^-23 on alternate block rows: a valid preconditioner of the same
    system whose f32 factor rounds otherwise (another device's rounding)."""
    jax = _jax()
    import jax.numpy as jnp
    from glio_tpu.solver import banded as JBand
    equilibrate = JBand._equilibrate

    def rescaled(band):
        band_s, s = equilibrate(band)
        T, B = band.shape[:2]
        hw = (B - 1) // 2
        f = 1.0 + sign * 2.0 ** -23 * jnp.where(jnp.arange(T) % 2 == 0, 1.0, -1.0)
        idx = jnp.arange(T)
        F = jnp.stack([jnp.where((idx + o - hw >= 0) & (idx + o - hw < T),
                                 jnp.roll(f, hw - o), 1.0) for o in range(B)], 1)
        return band_s * f[:, None, None, None] * F[:, :, None, None], s * f[:, None]
    jax.clear_caches()
    with unittest.mock.patch.object(JBand, "_equilibrate", rescaled):
        yield
    jax.clear_caches()


def _spread(runs, base, keys):
    return {k: np.array(max(float(np.abs(np.asarray(r[k]) - base[k]).max()) for r in runs))
            for k in keys}


def level0_problem(n_keyframes=None):
    """The level-0 drive (cut to ``n_keyframes``), its GNSS and JAX's problem
    build function at any odometry: (cfg, kf_time, p_true, q_true, p_odo, build)."""
    from glio_tpu.config import GlioConfig
    from glio_tpu.data.simulator import simulate_gnss_epochs
    from glio_tpu.models import batch as JB
    cfg = GlioConfig()
    kf_time, p_true, q_true, p_odo, anchor, station = batch_scenario(cfg)
    if n_keyframes is not None:
        kf_time, p_true, q_true, p_odo = (a[:n_keyframes] for a in (kf_time, p_true, q_true,
                                                                    p_odo))
    gnss = simulate_gnss_epochs(p_true, kf_time, anchor, station, psr_noise=BATCH["psr_noise"],
                                epoch_stride=BATCH["epoch_stride"], seed=BATCH["seed"])

    def build(p):
        return JB.build_problem(cfg, p, q_true, kf_time, gnss, anchor, 0.0, station)
    return cfg, kf_time, p_true, q_true, p_odo, build


def _robust():
    from glio_tpu.models import batch as JB
    return JB.RobustOpts(dd_huber=BATCH["dd_huber"], epoch_gate=BATCH["epoch_gate"],
                         rel_huber=BATCH["rel_huber"])


def nudged_odometry(p_odo):
    """The odometry nudged by ±1e-9 m, uniformly and with the sign
    alternating across keyframes. A uniform nudge moves only the LM's start
    (the relatives are differences of the odometry, the GNSS rows absolute),
    so it samples little of JAX's own spread; the alternating one moves the
    relatives (as phase 10 alternates its pseudorange nudge across
    satellites)."""
    alt = (-1.0) ** np.arange(p_odo.shape[0])[:, None]
    return [p_odo + s * f * VARIANTS["nudge_m"] for s in (1.0, -1.0) for f in (1.0, alt)]


def make_atm(out, cfg, p_odo, build):
    from glio_tpu.models import batch as JB
    nudged = [build(p) for p in nudged_odometry(p_odo)]
    prob = build(p_odo)
    for solver, key in (("direct", "atm"), ("chol_pcg", "atm_cp")):
        def run(pr):
            t0 = time.perf_counter()
            p, q, z, costs = JB.optimize_batch_atm(cfg, pr, thresholds=THRESHOLDS,
                                                   lm_iters=VARIANTS["atm_lm_iters"],
                                                   solver=solver, robust=_robust(), mixed=False)
            r = dict(p=np.asarray(p), q=np.asarray(q), z=np.asarray(z), costs=np.asarray(costs))
            print(f"  atm {solver}: {time.perf_counter() - t0:.1f} s, costs {costs}", flush=True)
            return r
        base = run(prob)
        out.update({f"{key}_{k}": v for k, v in base.items()})
        out.update({f"{key}_nudge_d{k}": v for k, v in
                    _spread([run(pr) for pr in nudged], base, "pqz").items()})
        if solver == "chol_pcg":
            runs = []
            for sign in (1.0, -1.0):
                with f32_rescaled(sign):
                    runs.append(run(prob))
            out.update({f"{key}_f32_nudge_d{k}": v for k, v in
                        _spread(runs, base, "pqz").items()})


def make_incremental(out, cfg, kf_time, p_odo, build):
    from glio_tpu.models import batch as JB

    def run(pr):
        t0 = time.perf_counter()
        with f64_inner_solves():
            p, q = JB.optimize_batch_incremental(
                cfg, pr, kf_time, every=VARIANTS["incr_every"], thresholds=THRESHOLDS,
                lm_iters=VARIANTS["incr_lm_iters"], robust=_robust(), rederive=True)
        print(f"  incremental every={VARIANTS['incr_every']}: {time.perf_counter() - t0:.1f} s",
              flush=True)
        return dict(p=np.asarray(p), q=np.asarray(q))
    base = run(build(p_odo))
    out.update(incr_p=base["p"], incr_q=base["q"])
    runs = [run(build(p)) for p in nudged_odometry(p_odo)]
    out.update({f"incr_nudge_d{k}": v for k, v in _spread(runs, base, "pq").items()})


def make_cadence():
    from glio_tpu.models import batch as JB
    cfg, kf_time, p_true, q_true, p_odo, build = level0_problem(VARIANTS["cadence_keyframes"])

    def run(pr):
        with f64_inner_solves():
            p, q, stats = JB.optimize_batch_reference_cadence(
                cfg, pr, every=VARIANTS["cadence_every"], thresholds=THRESHOLDS,
                robust=_robust())
        print(f"  cadence: {stats}", flush=True)
        return dict(p=np.asarray(p), q=np.asarray(q), n=stats["n_resolves"])
    base = run(build(p_odo))
    out = dict(p=base["p"], q=base["q"], n_resolves=np.array(base["n"]))
    runs = [run(build(p)) for p in nudged_odometry(p_odo)]
    out.update({f"nudge_d{k}": v for k, v in _spread(runs, base, "pq").items()})
    out["rmse_odo"] = np.array(np.sqrt(np.mean(np.sum((p_odo - p_true) ** 2, -1))))
    out["rmse"] = np.array(np.sqrt(np.mean(np.sum((base["p"] - p_true) ** 2, -1))))
    return cfg, out


def make_sms1(seed):
    from glio_tpu.data.simulator import simulate_episode, simulate_gnss_epochs
    from glio_tpu.lidar import plane_fit
    from glio_tpu.models import batch as JB
    from glio_tpu_torch.data.simulator import random_walk_odometry
    sc = {**SMS1, "seed": seed}
    cfg = sms1_config()
    anchor = np.asarray(cfg.initialization.anc_ecef)
    station = np.asarray(cfg.initialization.station_ecef)
    ep = simulate_episode(n_keyframes=sc["n_keyframes"], scan_points=sc["scan_points"],
                          seed=sc["seed"])
    gnss = simulate_gnss_epochs(ep.gt_p, ep.kf_time, anchor, station, psr_noise=sc["psr_noise"],
                                epoch_stride=sc["epoch_stride"], seed=sc["seed"])
    p_odo = random_walk_odometry(ep.gt_p, sc["seed"], sc["drift_step"], sc["odo_noise"])
    q_odo = np.asarray(ep.gt_q)
    chain = JB.build_imu_chain(cfg, ep.imu_acc, ep.imu_gyr, ep.imu_dt, ep.imu_valid)
    prob = JB.build_problem(cfg, p_odo, q_odo, ep.kf_time, gnss, anchor, 0.0, station)
    out = {"episode_checksums": checksums(ep.scan, ep.scan_valid, ep.imu_acc, ep.imu_gyr,
                                          ep.imu_dt, ep.gt_p, ep.gt_q, ep.gt_v),
           "problem_checksums": checksums(prob.p_odo, prob.psr_rov, prob.whiten,
                                          prob.ep_valid, prob.rel_dq)}

    def associated(p, f64_eigensystem):
        t0 = time.perf_counter()
        prob = JB.build_problem(cfg, p, q_odo, ep.kf_time, gnss, anchor, 0.0, station)
        fit = fit_planes_f64_eigensystem if f64_eigensystem else plane_fit.fit_planes_centroid
        with unittest.mock.patch.object(plane_fit, "fit_planes_centroid", fit):
            sms = JB.build_sms1(cfg, ep.scan, ep.scan_valid, p, q_odo)
        print(f"  associated ({'f64' if f64_eigensystem else 'f32'} eigensystem) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        return prob, sms

    def run(prob, sms, solve, solver):
        t0 = time.perf_counter()
        kw = dict(thresholds=THRESHOLDS, lm_iters=sc["lm_iters"], solver=solver, mixed=False)
        if solve == "pose":
            p, q, costs = JB.optimize_batch_sms1(cfg, prob, sms, **kw)
            r = dict(p=np.asarray(p), q=np.asarray(q))
        else:
            p, q, v, _, _, costs = JB.optimize_batch_sms1_imu(cfg, prob, sms, chain, **kw)
            r = dict(p=np.asarray(p), q=np.asarray(q), v=np.asarray(v))
        print(f"  {solve} {solver}: {time.perf_counter() - t0:.1f} s, costs {costs}", flush=True)
        return r

    # The results with the eigensystem in f64, as the port computes it; the
    # spread as phase 8 takes it: JAX's own association (f32 eigensystem) at
    # the odometry and at the odometry nudged by ±1e-9 m (``nudged_odometry``:
    # uniformly, as phase 8, and with alternating sign), each solved, the
    # nudged results against the unnudged one. The nudges flip near-ties of
    # the top-25 selection as the port's association does.
    combos = [(s, v) for s in ("pose", "imu") for v in ("pcg", "chol_pcg")]
    base_ps = associated(p_odo, True)
    bases = {}
    for solve, solver in combos:
        key = f"{solve}_{solver}"
        bases[key] = run(*base_ps, solve, solver)
        out.update({f"{key}_{k}": v for k, v in bases[key].items()})
    ps = associated(p_odo, False)
    ref = {f"{s}_{v}": run(*ps, s, v) for s, v in combos}
    nudged = {key: [] for key in bases}
    for p in nudged_odometry(p_odo):
        ps = associated(p, False)
        for solve, solver in combos:
            nudged[f"{solve}_{solver}"].append(run(*ps, solve, solver))
    for key, runs in nudged.items():
        keys = "pqv" if key.startswith("imu") else "pq"
        out.update({f"{key}_nudge_d{k}": v for k, v in _spread(runs, ref[key], keys).items()})
        out.update({f"{key}_f32eig_d{k}": v for k, v in
                    _spread([ref[key]], bases[key], keys).items()})
    for solve in ("pose", "imu"):
        key = f"{solve}_chol_pcg"
        runs = []
        for sign in (1.0, -1.0):
            with f32_rescaled(sign):
                runs.append(run(*base_ps, solve, "chol_pcg"))
        keys = "pqv" if solve == "imu" else "pq"
        out.update({f"{key}_f32_nudge_d{k}": v for k, v in
                    _spread(runs, bases[key], keys).items()})
    return cfg, sc, out


def _save(path, cfg, out, scenario):
    out["config_json"] = np.array(json.dumps(dataclasses.asdict(cfg)))
    out["scenario_json"] = np.array(json.dumps(scenario))
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({os.path.getsize(path) / 2**20:.2f} MiB): " + ", ".join(
        f"{k} {float(v):.3e}" for k, v in out.items() if "nudge" in k or "f32eig" in k), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=["atm", "incremental", "cadence", "sms1"])
    ap.add_argument("--seed", type=int, default=SMS1["seed"],
                    help="the seed of level 1's drive (sms1 only)")
    args = ap.parse_args()
    _jax()
    scenario = {**BATCH, **VARIANTS, "thresholds": THRESHOLDS}
    if args.only in (None, "atm", "incremental"):
        cfg, kf_time, p_true, q_true, p_odo, build = level0_problem()
        out = dict(np.load(OUT["level0"])) if args.only and os.path.exists(OUT["level0"]) else {}
        out.pop("config_json", None)
        out.pop("scenario_json", None)
        if args.only in (None, "atm"):
            make_atm(out, cfg, p_odo, build)
        if args.only in (None, "incremental"):
            make_incremental(out, cfg, kf_time, p_odo, build)
        _save(OUT["level0"], cfg, out, scenario)
    if args.only in (None, "cadence"):
        cfg, out = make_cadence()
        _save(OUT["cadence"], cfg, out, scenario)
    if args.only in (None, "sms1"):
        cfg, sc, out = make_sms1(args.seed)
        _save(OUT["sms1"].format(seed=args.seed), cfg, out, {**sc, "thresholds": THRESHOLDS})


if __name__ == "__main__":
    main()
