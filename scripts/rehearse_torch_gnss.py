"""The GNSS phase of ``chip_smoke.py`` (phase 15) on the CPU: RINEX input,
SPP, the Doppler / ``chol_pcg`` batch at T = 3493, the long-run
configuration and the Doppler window.

    python scripts/rehearse_torch_gnss.py [--only rinex|long_run|doppler_window]

Runs the phase with the kernels' plain versions (the card's 5-NN is the same
bit for bit) and holds it to ``tests/data/gnss_T3493_seed15.npz``,
``long_run_seed3.npz`` and ``window_doppler_seed0.npz`` with
``chip_smoke.py``'s gates, except the kernel launch counts, which only the
card has; exits 1 where a gate fails. Its times are the CPU's, not the
card's. ``rinex`` covers 15.1-15.3 (a few minutes); the replays take longer.
"""

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=["rinex", "long_run", "doppler_window"])
    args = ap.parse_args()
    # chol_pcg's f32 factor makes thousands of 6 x 6 Cholesky calls: one
    # thread runs each in microseconds, MKL's thread pool in milliseconds.
    torch.set_num_threads(1)
    dev = torch.device("cpu")
    try:
        if args.only in (None, "rinex"):
            fx, drive, g = chip_smoke.rinex_phase(dev)
            chip_smoke.spp_phase(dev, fx, drive, g)
            chip_smoke.gnss_batch_phase(dev, fx, drive, g)
        if args.only in (None, "long_run"):
            chip_smoke.long_run_phase(dev)
        if args.only in (None, "doppler_window"):
            chip_smoke.doppler_window_phase(dev)
    except RuntimeError as err:
        print(err)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
