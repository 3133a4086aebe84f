"""JAX trajectory fixture for the PyTorch port's check on the card.

Runs ``glio_tpu``'s sliding-window replay on the CPU at the ``bench.py``
shapes (window 5, local map width 50, 1024 scan points, 16,384 map points,
40 IMU samples, 15 LM iterations) over the 30-keyframe
``simulate_episode(seed=0)``, and writes p, q, v, cost and n_lidar_factors,
with the configuration used, to ``tests/data/sw_replay_w50_seed0.npz``.
``chip_smoke.py`` holds the port's replay on the card against it; the card
has no jax. ``tests/test_torch_fixture.py`` regenerates it and checks that
the stored file is still current.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_fixture.py
"""

import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "sw_replay_w50_seed0.npz")
N_KEYFRAMES = 30
SEED = 0


def config():
    from glio_tpu.config import EstimatorConfig, GlioConfig, ShapeConfig
    return GlioConfig().replace(
        shapes=ShapeConfig(max_imu_per_interval=40, scan_points=1024,
                           map_points=16384),
        estimator=EstimatorConfig(local_map_width=50, sw_max_iter=15))


def make_fixture() -> dict:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from glio_tpu.data.simulator import simulate_episode
    from glio_tpu.models.sliding_window import make_replay

    cfg = config()
    ep = simulate_episode(n_keyframes=N_KEYFRAMES, scan_points=1024, seed=SEED)
    replay, _ = make_replay(cfg)
    out = replay(ep.to_inputs(), ep.p0, ep.q0, ep.v0, ep.acc0, ep.gyr0)
    return {
        "p": np.asarray(out.p), "q": np.asarray(out.q), "v": np.asarray(out.v),
        "cost": np.asarray(out.cost),
        "n_lidar_factors": np.asarray(out.n_lidar_factors),
        "config_json": np.array(json.dumps(dataclasses.asdict(cfg))),
        "n_keyframes": np.array(N_KEYFRAMES), "seed": np.array(SEED),
    }


def main():
    sys.path.insert(0, ROOT)
    fx = make_fixture()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez(OUT, **fx)
    print(f"wrote {OUT}: n_lidar_factors {fx['n_lidar_factors'].tolist()}")


if __name__ == "__main__":
    main()
