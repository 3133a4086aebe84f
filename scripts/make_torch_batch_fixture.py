"""JAX fixtures for the PyTorch port's batch stage and pipeline on the card.

Runs ``glio_tpu`` on the CPU and writes two files that ``chip_smoke.py``
holds the port against (the card has no jax):

* ``tests/data/batch_T3493_seed4.npz`` — the batch stage at the length of
  the UrbanNav Whampoa sequence (3493 keyframes, ``bench.py:247-272``) on
  simulated GNSS: the drifted 3 Hz drive of
  ``glio_tpu_torch.data.simulator.drifted_trajectory`` (6 m of odometry
  drift), ``simulate_gnss_epochs(psr_noise=0.5, seed=4)`` every third
  keyframe, ``build_problem``, then ``optimize_batch`` with the bench's
  robust options, 4 stages x 10 LM iterations, ``solver="direct"``, in
  both precisions (``mixed=False``, the port's arithmetic, and
  ``mixed=True``, the JAX main path). Stored: checksums of the problem,
  p and q of both solves, the per-stage costs, the diagonal of the
  marginal covariance and the calibrated translation stds at the f64
  solution.
* ``tests/data/pipeline_seed0.npz`` — ``run_pipeline`` (stages 1-3) at
  the ``bench.py`` shapes on ``simulate_episode(n_keyframes=15, seed=0)``
  with GNSS at every keyframe (``epoch_stride=1``): the rows of
  ``tc_sw_result.csv``, ``tc_batch_result.csv``, ``tc_batch_cov.csv`` and
  ``lc_result.csv``, and n_lidar_factors per keyframe. The pipeline runs
  twice: as it is (its batch stage in mixed precision, the JAX main path)
  and with the batch solve in f64 (``*_f64`` keys), the port's arithmetic.
  On 15 keyframes the batch has not converged after 40 iterations and the
  two JAX runs end ~4 cm apart, so the port is held to the f64 run. Stage
  3 does not depend on the batch; its spread and its gain from a stage-1
  difference (``lc_*`` keys) come from
  ``scripts/make_torch_stage3_fixture.py::stage3_spread``.

Each file stores the configuration it was made with. Takes about two
minutes:

    JAX_PLATFORMS=cpu python scripts/make_torch_batch_fixture.py
"""

import dataclasses
import functools
import json
import os
import sys
import tempfile
import unittest.mock

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH_OUT = os.path.join(ROOT, "tests", "data", "batch_T3493_seed4.npz")
PIPE_OUT = os.path.join(ROOT, "tests", "data", "pipeline_seed0.npz")

BATCH = dict(n_keyframes=3493, seed=4, psr_noise=0.5, epoch_stride=3,
             max_drift=6.0, lm_iters=10, dd_huber=1.0, epoch_gate=2.0,
             rel_huber=5.0)
THRESHOLDS = (1e9, 10.0, 8.0, 6.0)
PIPE = dict(n_keyframes=15, scan_points=1024, seed=0, gnss_seed=0, epoch_stride=1)
CSV_NAMES = ("tc_sw_result.csv", "tc_batch_result.csv", "tc_batch_cov.csv", "lc_result.csv")


def problem_checksums(p_odo, psr_rov, whiten, ep_valid):
    """(4, 2): sum and sum of squares of each array, f64."""
    out = []
    for a in (p_odo, psr_rov, whiten, ep_valid):
        a = np.asarray(a, np.float64)
        out.append([a.sum(), (a * a).sum()])
    return np.array(out)


def batch_scenario(cfg):
    """(kf_time, p_true, q_true, p_odo, anchor, station) of the batch fixture."""
    from glio_tpu_torch.data.simulator import drifted_trajectory
    kf_time, p_true, q_true, p_odo = drifted_trajectory(
        BATCH["n_keyframes"], BATCH["max_drift"])
    return (kf_time, p_true, q_true, p_odo,
            np.asarray(cfg.initialization.anc_ecef),
            np.asarray(cfg.initialization.station_ecef))


def pipeline_config():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from make_torch_port_fixture import config
    return config()


def _jax_cpu():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def make_batch_fixture() -> dict:
    jax = _jax_cpu()
    from glio_tpu.config import GlioConfig
    from glio_tpu.data.simulator import simulate_gnss_epochs
    from glio_tpu.models import batch as B

    cfg = GlioConfig()
    kf_time, p_true, q_true, p_odo, anchor, station = batch_scenario(cfg)
    gnss = simulate_gnss_epochs(p_true, kf_time, anchor, station,
                                psr_noise=BATCH["psr_noise"],
                                epoch_stride=BATCH["epoch_stride"], seed=BATCH["seed"])
    prob = B.build_problem(cfg, p_odo, q_true, kf_time, gnss, anchor, 0.0, station)
    rob = B.RobustOpts(dd_huber=BATCH["dd_huber"], epoch_gate=BATCH["epoch_gate"],
                       rel_huber=BATCH["rel_huber"])
    out = {}
    for tag, mixed in (("f64", False), ("mixed", True)):
        p, q, costs = B.optimize_batch(cfg, prob, thresholds=THRESHOLDS,
                                       lm_iters=BATCH["lm_iters"], solver="direct",
                                       robust=rob, mixed=mixed)
        out[f"p_{tag}"] = np.asarray(p)
        out[f"q_{tag}"] = np.asarray(q)
        out[f"costs_{tag}"] = np.asarray(costs)
    p, q = jax.numpy.asarray(out["p_f64"]), jax.numpy.asarray(out["q_f64"])
    cov = B.batch_marginal_covariance(cfg, prob, p, q)
    cov_cal, rep = B.calibrate_batch_covariance(cfg, prob, p, q, cov)
    out["cov_diag"] = np.diagonal(np.asarray(cov), axis1=1, axis2=2).copy()
    out["std_cal_p"] = np.sqrt(np.diagonal(np.asarray(cov_cal), axis1=1, axis2=2)[:, :3])
    out["calibrated"] = np.array(bool(rep["calibrated"]))
    out["checksums"] = problem_checksums(prob.p_odo, prob.psr_rov, prob.whiten,
                                         prob.ep_valid)
    out["n_epochs"] = np.array(int(np.asarray(prob.ep_valid).shape[0]))
    out["config_json"] = np.array(json.dumps(dataclasses.asdict(cfg)))
    out["scenario_json"] = np.array(json.dumps(
        {**BATCH, "thresholds": THRESHOLDS, "solver": "direct"}))
    return out


def read_csv_rows(path):
    """The numbers of a result CSV (the covariance CSV has 3 header lines)."""
    skip = 3 if path.endswith("_cov.csv") else 0
    return np.loadtxt(path, delimiter=",", skiprows=skip, ndmin=2)


def make_pipeline_fixture() -> dict:
    _jax_cpu()
    from glio_tpu.data.simulator import simulate_episode, simulate_gnss_epochs
    from glio_tpu.models import batch as B
    from glio_tpu.models.sliding_window import make_replay
    from glio_tpu.pipeline import run_pipeline

    cfg = pipeline_config()
    ep = simulate_episode(n_keyframes=PIPE["n_keyframes"],
                          scan_points=PIPE["scan_points"], seed=PIPE["seed"])
    anchor = np.asarray(cfg.initialization.anc_ecef)
    ep.gnss = simulate_gnss_epochs(ep.gt_p, ep.kf_time, anchor,
                                   np.asarray(cfg.initialization.station_ecef),
                                   epoch_stride=PIPE["epoch_stride"],
                                   seed=PIPE["gnss_seed"])
    ep.anchor_ecef = anchor
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        res = run_pipeline(ep, cfg, out_dir=tmp)
        for name in CSV_NAMES:
            out[name.replace(".csv", "")] = read_csv_rows(os.path.join(tmp, name))
    f64_solve = functools.partial(B.optimize_batch, mixed=False)
    with tempfile.TemporaryDirectory() as tmp, \
            unittest.mock.patch.object(B, "optimize_batch", f64_solve):
        run_pipeline(ep, cfg, out_dir=tmp, run_lc=False)
        for name in CSV_NAMES[1:3]:
            out[name.replace(".csv", "_f64")] = read_csv_rows(os.path.join(tmp, name))
    from make_torch_stage3_fixture import stage3_spread
    out.update(stage3_spread(cfg, ep, res.p_sw, res.q_sw, anchor, 0.0,
                             np.asarray(cfg.initialization.station_ecef)))
    replay, _ = make_replay(cfg)
    sw = replay(ep.to_inputs(), ep.p0, ep.q0, ep.v0, ep.acc0, ep.gyr0)
    out["n_lidar_factors"] = np.asarray(sw.n_lidar_factors)
    out["config_json"] = np.array(json.dumps(dataclasses.asdict(cfg)))
    out["scenario_json"] = np.array(json.dumps(PIPE))
    return out


def main():
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    os.makedirs(os.path.dirname(BATCH_OUT), exist_ok=True)
    fx = make_batch_fixture()
    np.savez_compressed(BATCH_OUT, **fx)
    floor = np.abs(fx["p_f64"] - fx["p_mixed"]).max()
    print(f"wrote {BATCH_OUT}: costs f64 {fx['costs_f64'].tolist()}, mixed "
          f"{fx['costs_mixed'].tolist()}; max |p_mixed - p_f64| {floor:.3e} m")
    fx = make_pipeline_fixture()
    np.savez_compressed(PIPE_OUT, **fx)
    gap = np.abs(fx["tc_batch_result"][:, 9:12] - fx["tc_batch_result_f64"][:, 9:12]).max()
    print(f"wrote {PIPE_OUT}: n_lidar_factors {fx['n_lidar_factors'].tolist()}; "
          f"batch ENU, mixed vs f64: max {gap:.3e} m")


if __name__ == "__main__":
    main()
