"""Phase 8 of ``chip_smoke.py`` (batch level 1 at 3493 keyframes) on the CPU.

    python scripts/rehearse_torch_sms1.py

Simulates the scenario of ``tests/data/sms1_T3493_seed4.npz``, associates
(``build_sms1`` with the 5-NN's plain version; the card's association is
the same, bit for bit), solves once and holds both to the fixture's JAX
results with ``chip_smoke.py``'s gates; prints the readings as one JSON
line and exits 1 where a gate fails. Nothing is timed. About ten minutes
on six cores and 4 GB.
"""

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from glio_tpu_torch.models import batch as batch_mod  # noqa: E402


def main():
    dev = torch.device("cpu")
    s = chip_smoke.sms1_scenario(dev)
    ep, sc = s.ep, s.sc
    sms = batch_mod.build_sms1(s.cfg, ep.scan, ep.scan_valid, s.p_odo, s.q_odo, device=dev)
    chain = batch_mod.build_imu_chain(s.cfg, ep.imu_acc, ep.imu_gyr, ep.imu_dt, ep.imu_valid,
                                      device=dev)
    out = batch_mod.optimize_batch_sms1_imu(s.cfg, s.prob, sms, chain,
                                            thresholds=tuple(sc["thresholds"]),
                                            lm_iters=sc["lm_iters"], solver=sc["solver"])
    try:
        readings = chip_smoke.sms1_against_jax(s, sms, chain, out, dev)
    except RuntimeError as err:
        print(err)
        return 1
    print(json.dumps(readings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
