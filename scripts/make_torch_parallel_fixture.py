"""JAX fixture for the multi-device batch solve of the PyTorch port on the card.

Runs ``glio_tpu`` on a 4-device CPU mesh and writes
``tests/data/parallel_T3493_seed4.npz``, which ``chip_smoke.py``'s phase 18
holds the port's four ranks against. The drive is the batch fixture's
(``scripts/make_torch_batch_fixture.py``: 3493 keyframes, GNSS every third,
the bench's robust options, 4 stages x 10 LM iterations).

Stored, and the gate each gives (phase 18):

* ``p_sharded``, ``q_sharded``, ``costs_sharded``: ``optimize_batch_sharded``'s
  stage on the 4-device mesh (the function itself would place the problem's
  time axis on the mesh, which needs T divisible by 4); ``d_p_sharded`` / ``d_q_sharded``: their largest
  distance from JAX's single-device ``optimize_batch(solver="direct",
  mixed=False)`` (``p_single``, ``q_single``). ``nudge_p`` / ``nudge_q``:
  JAX's own spread, the largest move of either solve when the odometry is
  nudged by 1e-9 m (four nudges: signs alternating along the drive, all +,
  all -, random). The LM's accept
  decisions near convergence turn round-off into moves of up to that
  spread, so the port's sharded solve is held to 10x the larger of the two
  readings against the port's single-device solve on the card, and against
  JAX f64 to the batch phase's 3e-4 m.
* ``pcg_rel``: JAX's ``make_sharded_pcg`` at dp = 2, sp = 2, 60 iterations,
  on two level-0 bands (at the odometry, threshold 1e9, and at JAX's f64
  solution, threshold 6; robust weights; damped by 1e-4 as an LM iteration
  damps them; padded to T = 3494 with an identity row), against
  ``pcg_solve`` with the same iterations on each: max over the two of
  max |x_sharded - x_single| / max |x_single|. The port's is held to 10x it.
* ``cr_rel``: JAX's ``make_sharded_cr_solve`` against ``cyclic_reduction_solve``
  on the second band, max |dx| / max |x|, for the record (the gate of the
  sharded direct solve is 1e-8, ``__graft_entry__.py::dryrun_multichip``'s).

About five minutes:

    JAX_PLATFORMS=cpu python scripts/make_torch_parallel_fixture.py
"""

import dataclasses
import json
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4").strip()

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "parallel_T3493_seed4.npz")
PCG_ITERS = 60
LAM = 1e-4
NUDGE_M = 1e-9


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def main():
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from glio_tpu.config import GlioConfig
    from glio_tpu.data.simulator import simulate_gnss_epochs
    from glio_tpu.models import batch as B
    from glio_tpu.parallel import banded_pcg, spike_cr
    from glio_tpu.solver import banded
    from make_torch_batch_fixture import BATCH, THRESHOLDS, batch_scenario

    assert jax.device_count() >= 4, "needs 4 host devices"
    cfg = GlioConfig()
    hw = cfg.estimator.search_range + 1
    kf_time, p_true, q_true, p_odo, anchor, station = batch_scenario(cfg)
    gnss = simulate_gnss_epochs(p_true, kf_time, anchor, station, psr_noise=BATCH["psr_noise"],
                                epoch_stride=BATCH["epoch_stride"], seed=BATCH["seed"])
    prob = B.build_problem(cfg, p_odo, q_true, kf_time, gnss, anchor, 0.0, station)
    rob = B.RobustOpts(dd_huber=BATCH["dd_huber"], epoch_gate=BATCH["epoch_gate"],
                       rel_huber=BATCH["rel_huber"])
    devs = np.array(jax.devices()[:4])
    out = {}
    p1, q1, c1 = B.optimize_batch(cfg, prob, thresholds=THRESHOLDS, lm_iters=BATCH["lm_iters"],
                                  solver="direct", robust=rob, mixed=False)
    # optimize_batch_sharded itself device_puts the problem's time-axis
    # leaves onto the mesh, which needs T divisible by 4; 3493 is not. So its
    # stage runs here on the problem as it is: the SPIKE solve on the 4-device
    # mesh, the assembly unsharded, as every rank of the port assembles it.
    stage = B._sharded_stage(cfg, Mesh(devs, ("sp",)), BATCH["lm_iters"], rob, "sp")
    ps, qs, cs = prob.p_odo, prob.q_odo, []
    for th in THRESHOLDS:
        ps, qs, c = stage(prob, ps, qs, jnp.asarray(th, jnp.float64))
        cs.append(float(c))
    out.update(p_single=np.asarray(p1), q_single=np.asarray(q1), costs_single=np.asarray(c1),
               p_sharded=np.asarray(ps), q_sharded=np.asarray(qs), costs_sharded=np.asarray(cs))
    out["d_p_sharded"] = np.array(np.abs(out["p_sharded"] - out["p_single"]).max())
    out["d_q_sharded"] = np.array(np.abs(out["q_sharded"] - out["q_single"]).max())
    T = len(p_odo)
    signs = (np.where(np.arange(T) % 2 == 0, 1.0, -1.0), np.ones(T), -np.ones(T),
             np.random.default_rng(0).choice([-1.0, 1.0], T))
    nudge_p, nudge_q = [], []
    for sign in signs:
        nudged = prob._replace(p_odo=prob.p_odo + NUDGE_M * sign[:, None])
        pn, qn, _ = B.optimize_batch(cfg, nudged, thresholds=THRESHOLDS,
                                     lm_iters=BATCH["lm_iters"], solver="direct", robust=rob,
                                     mixed=False)
        psn, qsn = nudged.p_odo, nudged.q_odo
        for th in THRESHOLDS:
            psn, qsn, _ = stage(nudged, psn, qsn, jnp.asarray(th, jnp.float64))
        nudge_p += [np.abs(np.asarray(pn) - out["p_single"]).max(),
                    np.abs(np.asarray(psn) - out["p_sharded"]).max()]
        nudge_q += [np.abs(np.asarray(qn) - out["q_single"]).max(),
                    np.abs(np.asarray(qsn) - out["q_sharded"]).max()]
    out["nudge_p"], out["nudge_q"] = np.array(max(nudge_p)), np.array(max(nudge_q))

    bands, rhs = [], []
    for p, q, th in ((prob.p_odo, prob.q_odo, THRESHOLDS[0]), (p1, q1, THRESHOLDS[-1])):
        band, grad, *_ = B._assemble_robust(p, q, prob, jnp.asarray(th), hw, False, rob, False)
        diag = band[:, hw]
        eye = jnp.eye(6)
        band = band.at[:, hw].set(diag + LAM * (
            eye * jnp.maximum(jnp.diagonal(diag, axis1=-2, axis2=-1), 1.0)[..., None, :] * eye))
        bands.append(band)
        rhs.append(-grad)
    x_cr = spike_cr.make_sharded_cr_solve(Mesh(devs, ("sp",)), hw=hw)(bands[1], rhs[1])
    out["cr_rel"] = np.array(_rel(x_cr, banded.cyclic_reduction_solve(bands[1], rhs[1])))
    band2 = jnp.stack(bands)
    b2 = jnp.stack(rhs)
    pad = -band2.shape[1] % 2
    band2 = jnp.concatenate([band2, jnp.zeros((2, pad) + band2.shape[2:]).at[:, :, hw].set(
        jnp.eye(6))], axis=1)
    b2 = jnp.concatenate([b2, jnp.zeros((2, pad, 6))], axis=1)
    x_sh, _ = banded_pcg.make_sharded_pcg(Mesh(devs.reshape(2, 2), ("dp", "sp")), hw=hw,
                                          iters=PCG_ITERS)(band2, b2)
    out["pcg_rel"] = np.array(max(
        _rel(x_sh[n], banded.pcg_solve(band2[n], b2[n], iters=PCG_ITERS)[0]) for n in range(2)))
    out["config_json"] = np.array(json.dumps(dataclasses.asdict(cfg)))
    out["scenario_json"] = np.array(json.dumps(
        {**BATCH, "thresholds": THRESHOLDS, "pcg_iters": PCG_ITERS, "lam": LAM, "ranks": 4,
         "pcg_layout": [2, 2]}))
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: sharded vs single max |dp| {float(out['d_p_sharded']):.3e} m, "
          f"|dq| {float(out['d_q_sharded']):.3e}; nudge spread |dp| {float(out['nudge_p']):.3e} "
          f"m, |dq| {float(out['nudge_q']):.3e}; PCG rel {float(out['pcg_rel']):.3e}; "
          f"CR rel {float(out['cr_rel']):.3e}; costs {out['costs_sharded'].tolist()}")


if __name__ == "__main__":
    main()
