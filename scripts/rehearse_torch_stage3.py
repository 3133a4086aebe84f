"""Phases 10-13 of ``chip_smoke.py`` on the CPU: stage 3 at 3493 keyframes,
backend fusion, loop closure and the dense frames / map export.

    python scripts/rehearse_torch_stage3.py [--only lc|fusion|loop|dense]

Runs each phase with the kernels' plain versions (the card's 5-NN is the
same bit for bit) and holds it to its JAX fixture with ``chip_smoke.py``'s
gates, except the kernel launch counts, which only the card has; exits 1
where a gate fails. Its times are the CPU's, not the card's. About ten
minutes at the bench shapes, most of it backend fusion's replay.
"""

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("lc", "fusion", "loop", "dense"))
    args = ap.parse_args()
    dev = torch.device("cpu")
    phases = {"lc": chip_smoke.lc_phase, "fusion": chip_smoke.fusion_phase,
              "loop": chip_smoke.loop_phase, "dense": chip_smoke.dense_phase}
    try:
        for name, phase in phases.items():
            if args.only in (None, name):
                phase(dev)
    except RuntimeError as err:
        print(err)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
