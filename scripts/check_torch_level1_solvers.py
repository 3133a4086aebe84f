"""Phase 17 of ``chip_smoke.py`` (level 1's ``pcg`` and ``chol_pcg`` solves
at T = 3493) at another seed of its drive, on the card.

    python3 scripts/check_torch_level1_solvers.py [--seed 5]

Simulates the drive of ``tests/data/batch_variants_sms1_T3493_seed<N>.npz``
(``scripts/make_torch_batch_variants_fixture.py --only sms1 --seed N``), held
to the fixture's checksums, associates it on the card (``build_sms1``) and
runs ``chip_smoke.sms1_solvers_phase`` against that fixture: the four solves
within 10x JAX f64's own spread at that seed, each printed beside the
distance between JAX's results with its own association and with the f64
eigensystem, then the D = 15 kernels against their plain versions. Exits 1
where a gate fails.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args()
    fixture = os.path.join(ROOT, "tests", "data",
                           f"batch_variants_sms1_T3493_seed{args.seed}.npz")
    try:
        dev = chip_smoke.device_phase()
        print(f"build: {chip_smoke._build.build_all():.1f} s")
        s = chip_smoke.sms1_scenario(dev, fixture)
        sms = chip_smoke.batch_mod.build_sms1(s.cfg, s.ep.scan, s.ep.scan_valid, s.p_odo,
                                              s.q_odo, device=dev)
        chain = chip_smoke.batch_mod.build_imu_chain(s.cfg, s.ep.imu_acc, s.ep.imu_gyr,
                                                     s.ep.imu_dt, s.ep.imu_valid, device=dev)
        chip_smoke.sms1_solvers_phase(dev, (s, sms, chain), fixture)
    except RuntimeError as err:
        print(err)
        return 1
    print("check_torch_level1_solvers: passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
