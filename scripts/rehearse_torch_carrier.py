"""Phases 15.6-17 of ``chip_smoke.py`` on the CPU: the carrier-phase path,
the batch variants (zenith-bias chain, incremental, reference cadence) and
level 1's iterative solvers.

    python scripts/rehearse_torch_carrier.py [--only carrier|variants|sms1]

Runs the phases with the kernels' plain versions and holds them to
``tests/data/carrier_T3493_seed15.npz`` and ``tests/data/batch_variants_*.npz``
with ``chip_smoke.py``'s gates, except the kernel launch counts, which only
the card has; exits 1 where a gate fails. Its times are the CPU's, not the
card's. ``carrier`` (with phase 15.1's conversion) takes a few minutes;
``variants`` and ``sms1`` (with phase 8's association) are long on the CPU:
the f32 band factor and its applies are Python loops over 3493 block rows.
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
    ap.add_argument("--only", choices=["carrier", "variants", "sms1"])
    args = ap.parse_args()
    # Long chains of small ops (the filter, the band factor's 3493 rows):
    # one thread runs each in microseconds, a thread pool in milliseconds.
    torch.set_num_threads(1)
    dev = torch.device("cpu")
    try:
        if args.only in (None, "carrier"):
            _, drive, g = chip_smoke.rinex_phase(dev)
            chip_smoke.carrier_phase(dev, drive, g)
        if args.only in (None, "variants"):
            chip_smoke.batch_variants_phase(dev)
        if args.only in (None, "sms1"):
            s = chip_smoke.sms1_scenario(dev)
            sms = chip_smoke.batch_mod.build_sms1(s.cfg, s.ep.scan, s.ep.scan_valid, s.p_odo,
                                                  s.q_odo, device=dev)
            chain = chip_smoke.batch_mod.build_imu_chain(s.cfg, s.ep.imu_acc, s.ep.imu_gyr,
                                                         s.ep.imu_dt, s.ep.imu_valid, device=dev)
            chip_smoke.sms1_solvers_phase(dev, (s, sms, chain))
    except RuntimeError as err:
        print(err)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
