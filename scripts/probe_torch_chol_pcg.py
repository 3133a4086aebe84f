"""How the order of the f32 factorization moves ``chol_pcg``, on the CPU.

``chol_pcg`` stops after 14 CG iterations, short of convergence on a long
stiff chain, so its result depends on how its f32 preconditioner rounds.
This script takes the level-0 batch of ``chip_smoke.py`` phase 15.3 (T = 3493,
Doppler rows, ``tests/data/gnss_T3493_seed15.npz``) and compares two f32
factors of the same equilibrated band:

* ``block-row``: the port's ``banded.f32_chol_precond``, JAX's order
  (``block_cholesky`` one D-block row at a time);
* ``super-row``: the same Cholesky factor taken one hw·D super-row at a time
  (a 42 x 42 Cholesky and triangular solve per step), as the port first did,
  with its apply over the super-rows (``super_row_apply``).

It prints, for the band of the 6th LM iteration (where JAX's ``chol_pcg``
lies 5.6e-3 m from the exact step), each apply's distance to the apply of
the exact f64 factor and to JAX's ``_f32_chol_precond``, and then the whole
4-stage solve of each against JAX's ``chol_pcg`` p in the fixture, beside
JAX's own spread under a 1-ulp rescaling of its preconditioner.

    JAX_PLATFORMS=cpu python scripts/probe_torch_chol_pcg.py

Imports JAX for ``_f32_chol_precond`` only. On the CPU the block-row apply
is ``block_cholesky_solve``, a Python loop over the 3493 block rows, so the
two whole solves take most of the run.
"""

import os
import sys
import tempfile
import unittest.mock
from typing import NamedTuple

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from glio_tpu_torch import config as config_mod, testing  # noqa: E402
from glio_tpu_torch.gnss import converter  # noqa: E402
from glio_tpu_torch.models import batch as TB  # noqa: E402
from glio_tpu_torch.solver import banded  # noqa: E402

FIXTURE = os.path.join(ROOT, "tests", "data", "gnss_T3493_seed15.npz")


class SuperRowPrecond(NamedTuple):
    """M = L Lᵀ by hw·D super-rows: M⁻¹r is y_i = a_i − G_i y_{i−1} (a =
    L_ii⁻¹ r) forward, then x_i = b_i − H_i x_{i+1} (b = L_ii⁻ᵀ y)
    backward, in f32."""
    s: torch.Tensor       # (T, D) f64 equilibration
    Linv: torch.Tensor    # (N, S, S): L_ii⁻¹
    G: tuple              # N × (S, S): L_ii⁻¹ L_{i,i−1} (G[0] = 0)
    H: tuple              # N × (S, S): (L_{i+1,i} L_ii⁻¹)ᵀ (H[N−1] = 0)


def super_row_precond(band, jitter=3e-4):
    """The Cholesky factor of the equilibrated f32 band one super-row at a
    time (``banded.band_to_tridiag``), in ``super_row_apply``'s form."""
    band_s, s = banded._equilibrate(band)
    A, Bm, _, N, S = banded.band_to_tridiag(band_s.to(torch.float32))
    eye = torch.eye(S, dtype=torch.float32)
    Ls, subs, L = [], [], None
    for i in range(N):
        Si, sub = Bm[i] + jitter * eye, torch.zeros_like(eye)
        if i:
            sub = torch.linalg.solve_triangular(L, A[i].mT, upper=False).mT
            Si = Si - sub @ sub.mT
        L = torch.linalg.cholesky(Si)
        Ls.append(L)
        subs.append(sub)
    L, sub = torch.stack(Ls), torch.stack(subs)
    Linv = torch.linalg.solve_triangular(L, eye.expand(N, S, S), upper=False)
    H = torch.cat([(sub[1:] @ Linv[:-1]).mT, torch.zeros_like(eye)[None]])
    return SuperRowPrecond(s, Linv, (Linv @ sub).unbind(0), H.unbind(0))


def super_row_apply(M, r):
    """M⁻¹ r for r (T, D) f64 over the super-rows, in f32; returns f64."""
    T, D = r.shape
    N, S = M.Linv.shape[:2]
    rs = torch.zeros((N * S // D, D), dtype=torch.float32, device=r.device)
    rs[:T] = (r * M.s).to(torch.float32)
    a = (M.Linv @ rs.reshape(N, S, 1))[..., 0].unbind(0)
    y = [a[0]]
    for i in range(1, N):
        y.append(torch.addmv(a[i], M.G[i], y[-1], alpha=-1.0))
    b = (M.Linv.mT @ torch.stack(y)[..., None])[..., 0].unbind(0)
    x = [b[N - 1]]
    for i in range(N - 2, -1, -1):
        x.append(torch.addmv(b[i], M.H[i], x[-1], alpha=-1.0))
    out = torch.stack(x[::-1]).reshape(-1, D)[:T]
    return out.to(r.dtype) * M.s


def main():
    # Thousands of 6 x 6 Cholesky calls: one thread runs each in microseconds,
    # MKL's thread pool in milliseconds.
    torch.set_num_threads(1)
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from glio_tpu.solver import banded as JBand

    fx = np.load(FIXTURE)
    sc = dict(testing.GNSS_DRIVE)
    cfg = testing.gnss_batch_config(config_mod)
    station = np.asarray(cfg.initialization.station_ecef)
    kf_time, _, q_true, p_odo, t_gps, rover = testing.gnss_drive(sc)
    with tempfile.TemporaryDirectory() as d:
        obs, nav = os.path.join(d, "drive.obs"), os.path.join(d, "drive.nav")
        testing.write_synthetic_rinex(obs, nav, t_gps, rover, seed=sc["seed"], n_gps=sc["n_gps"],
                                      n_bds=sc["n_bds"], psr_noise=sc["psr_noise"])
        g = converter.convert(obs, nav, station)
    prob = TB.build_problem(cfg, p_odo, q_true, kf_time, g,
                            np.asarray(cfg.initialization.anc_ecef), 0.0, station,
                            device=torch.device("cpu"))
    gb = testing.GNSS_BATCH
    robust = TB.RobustOpts(dd_huber=gb["dd_huber"], epoch_gate=gb["epoch_gate"],
                           rel_huber=gb["rel_huber"])

    def solve(solver):
        return TB.optimize_batch(cfg, prob, thresholds=gb["thresholds"],
                                 lm_iters=gb["lm_iters"], solver=solver, robust=robust)

    # The band of the 6th LM iteration, from the exact path.
    seen = []
    cr = banded.cyclic_reduction_solve

    def recording(band, b):
        seen.append((band.clone(), b.clone()))
        return cr(band, b)
    with unittest.mock.patch.object(banded, "cyclic_reduction_solve", recording):
        p_direct, _, _ = solve("direct")
    band, b = seen[5]
    band_s, s = banded._equilibrate(band)
    r = torch.as_tensor(np.random.default_rng(0).standard_normal(tuple(b.shape)))
    exact = banded.block_cholesky_solve(banded.block_cholesky(band_s, jitter=3e-4), r * s) * s
    jax_z = torch.as_tensor(np.asarray(JBand._f32_chol_precond(jnp.asarray(band.numpy()))(
        jnp.asarray(r.numpy()))))
    rel = lambda z, ref: float((z - ref).abs().max() / ref.abs().max())
    x_jax = np.asarray(JBand.pcg_chol_solve(jnp.asarray(band.numpy()), jnp.asarray(b.numpy())))
    x_exact = banded.direct_solve(band, b).numpy()
    print(f"band of LM iteration 6 (T={band.shape[0]}): JAX's chol_pcg step lies "
          f"{np.abs(x_jax - x_exact).max():.3e} from the exact step; JAX's apply vs the exact "
          f"factor's {rel(jax_z, exact):.3e} (max-norm, relative)")
    precond = {"block-row": (banded.f32_chol_precond, banded.f32_chol_apply),
               "super-row": (super_row_precond, super_row_apply)}
    for name, (make, apply) in precond.items():
        z = apply(make(band), r)
        print(f"  {name}: apply vs the exact factor's {rel(z, exact):.3e}, vs JAX's "
              f"{rel(z, jax_z):.3e}")
    p_cp = fx["p_cp"]
    print(f"whole solve (4 stages x 10 LM iterations) against JAX's chol_pcg p: direct "
          f"{np.abs(p_direct.numpy() - p_cp).max():.3e} m")
    for name, (make, apply) in precond.items():
        with unittest.mock.patch.object(banded, "f32_chol_precond", make), \
                unittest.mock.patch.object(banded, "f32_chol_apply", apply):
            p, _, _ = solve("chol_pcg")
        print(f"  chol_pcg, {name} factor: {np.abs(p.numpy() - p_cp).max():.3e} m")
    print(f"JAX chol_pcg's own spread: {float(fx['f32_nudge_dp_cp']):.3e} m under a 1-ulp "
          f"rescaling of its preconditioner, {float(fx['nudge_dp_cp']):.3e} m under a "
          f"+-1e-9 m nudge of the odometry")


if __name__ == "__main__":
    main()
