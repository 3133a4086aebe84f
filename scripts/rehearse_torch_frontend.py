"""The raw-input phase of ``chip_smoke.py`` on the CPU: a bz2 ROS1 bag of 20
raycast HDL-32E frames through ``ingest.episode_from_rosbag`` and
``run_pipeline`` (stage 1 with ``diverse_select``).

    python scripts/rehearse_torch_frontend.py

Runs the phase with the kernels' plain versions (the card's 5-NN is the same
bit for bit) and holds it to ``tests/data/frontend_hdl32_seed8.npz`` with
``chip_smoke.py``'s gates, except the kernel launch counts, which only the
card has; exits 1 where a gate fails. Its times are the CPU's, not the
card's. A few minutes.
"""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main():
    chip_smoke.RAYCAST_WORKERS = 4
    try:
        chip_smoke.raw_input_phase(torch.device("cpu"))
    except RuntimeError as err:
        print(err)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
