"""How the rounding of ``chol_pcg``'s f32 apply moves the long run, on the card.

``scripts/long_run.py``'s configuration solves its backend-fusion windows
and its batch with ``chol_pcg``: 14 CG iterations, short of convergence, so
the result follows the f32 rounding of the preconditioner. The fused
positions replace stage 1's (``tc_sw_result.csv``). This script runs
``chip_smoke.py``'s long-run phase (30 keyframes, against
``tests/data/long_run_seed3.npz``) twice on the card: with the solve kernel
(``ops.band_chol.band_cholesky_solve``), then with its plain version
(``banded.block_cholesky_solve``) in its place, the factor kernel in both.
It records the bands of the first run's ``chol_pcg`` solves and prints, for
the one whose two results differ most, the applies' and the solves'
kernel-against-plain distances and the solve's distance to the exact one.

    python3 scripts/probe_torch_long_run_apply.py

Needs a card; about five minutes.
"""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from glio_tpu_torch.ops import band_chol  # noqa: E402
from glio_tpu_torch.solver import banded  # noqa: E402
from glio_tpu_torch.utils import profiling  # noqa: E402


def plain_solve(Lb, b):
    """The plain version, counted as the phase counts the kernel: in the
    tally ``band_cholesky_solve.launches``."""
    profiling.tally("band_cholesky_solve.launches")
    return banded.block_cholesky_solve(Lb, b)


def rel(a, ref):
    return float((a - ref).abs().max() / ref.abs().max())


def main():
    dev = chip_smoke.device_phase()
    seen = []
    pcg = banded.pcg_chol_solve

    def recording(band, b, *a, **k):
        seen.append((band.clone(), b.clone()))
        return pcg(band, b, *a, **k)

    banded.pcg_chol_solve = recording
    print("== the solve kernel", flush=True)
    chip_smoke.long_run_phase(dev)
    banded.pcg_chol_solve = pcg
    kernel = band_chol.band_cholesky_solve
    band_chol.band_cholesky_solve = plain_solve
    print("== its plain version on the card", flush=True)
    chip_smoke.long_run_phase(dev)
    worst = None
    for band, b in seen:
        band_chol.band_cholesky_solve = kernel
        x_k = banded.pcg_chol_solve(band, b)
        band_chol.band_cholesky_solve = plain_solve
        x_p = banded.pcg_chol_solve(band, b)
        if worst is None or rel(x_k, x_p) > worst[0]:
            worst = (rel(x_k, x_p), band, b, x_p)
    band_chol.band_cholesky_solve = kernel
    d, band, b, x_p = worst
    M = banded.f32_chol_precond(band)
    r = b * M.s
    apply = rel(kernel(M.Lb, r.to(torch.float32)), plain_solve(M.Lb, r.to(torch.float32)))
    print(f"{len(seen)} chol_pcg solves; the one whose results differ most (T={band.shape[0]}): "
          f"applies kernel vs plain {apply:.3e}, solves kernel vs plain {d:.3e}, plain solve vs "
          f"exact {rel(x_p, banded.direct_solve(band, b)):.3e} (max-norm, relative)")


if __name__ == "__main__":
    main()
