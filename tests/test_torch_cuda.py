"""The port's CUDA path on the card: the k-NN kernel against its plain
version, bit for bit, and the replay on the card against the replay on the
CPU.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no jax, so it runs on a machine that has only torch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` sets up jax.)
"""

import numpy as np
import pytest
import torch

from glio_tpu_torch.config import EstimatorConfig, GlioConfig, ShapeConfig
from glio_tpu_torch.data.simulator import simulate_episode
from glio_tpu_torch.lidar import neighbors
from glio_tpu_torch.models.sliding_window import SlidingWindowEstimator
from glio_tpu_torch.ops import knn as knn_mod

pytestmark = pytest.mark.cuda
F32 = np.float32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _cloud(rng, n, offset=(300.0, -80.0, 2.0), spread=40.0, valid_share=0.9):
    pts = (rng.uniform(-spread, spread, size=(n, 3)) + offset).astype(F32)
    return pts, rng.uniform(size=n) < valid_share


CASES = {
    # The window association's shape: 5 x 1024 queries, 16,384 map points.
    "main_path": lambda r: (*_cloud(r, 5120), *_cloud(r, 16384)),
    "ragged": lambda r: (*_cloud(r, 77), *_cloud(r, 1000)),
    "fewer_valid_than_k": lambda r: (*_cloud(r, 300), *_cloud(r, 64, valid_share=0.05)),
    "empty_map": lambda r: (*_cloud(r, 50), *_cloud(r, 0)),
    "ties": lambda r: (np.zeros((3, 3), F32), np.ones(3, bool),
                       np.repeat(np.eye(3, dtype=F32), 4, axis=0), np.ones(12, bool)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_equals_plain_version(cuda, case):
    args = [torch.tensor(a, device=cuda) for a in CASES[case](np.random.default_rng(0))]
    before = knn_mod.knn.launches
    d_k, i_k = knn_mod.knn(*args)
    d_r, i_r = knn_mod.knn_reference(*args)
    torch.cuda.synchronize()
    assert knn_mod.knn.launches == before + 1
    assert torch.equal(i_k, i_r)
    assert torch.equal(d_k, d_r)


def test_kernel_rejects_other_k(cuda):
    args = [torch.tensor(a, device=cuda) for a in CASES["ragged"](np.random.default_rng(0))]
    with pytest.raises(ValueError):
        knn_mod.knn(*args, k=3)


def test_voxel_downsample_equals_cpu(cuda):
    pts, valid = _cloud(np.random.default_rng(1), 51200, spread=60.0)
    out_c, v_c = neighbors.voxel_downsample(torch.tensor(pts), torch.tensor(valid),
                                            0.4, 16384, scatter_keys=True)
    out_g, v_g = neighbors.voxel_downsample(torch.tensor(pts, device=cuda),
                                            torch.tensor(valid, device=cuda),
                                            0.4, 16384, scatter_keys=True)
    assert v_c.all()                     # more voxels than rows: truncated
    assert torch.equal(v_g.cpu(), v_c) and torch.equal(out_g.cpu(), out_c)


def test_replay_on_card_matches_cpu(cuda):
    """Same port, two devices: the association must agree factor for factor
    and the trajectory to 1e-6 m (f64 sums in another order)."""
    cfg = GlioConfig().replace(
        shapes=ShapeConfig(max_imu_per_interval=40, scan_points=256, map_points=2048),
        estimator=EstimatorConfig(local_map_width=8, sw_max_iter=4))
    ep = simulate_episode(n_keyframes=6, scan_points=256, seed=1)
    outs = {}
    for dev in ("cpu", cuda):
        est = SlidingWindowEstimator(cfg, dev)
        outs[str(dev)] = est.replay(ep.to_inputs(dev), ep.p0, ep.q0, ep.v0,
                                    ep.acc0, ep.gyr0)
    c, g = outs["cpu"], outs[str(cuda)]
    assert torch.equal(c.n_lidar_factors, g.n_lidar_factors.cpu())
    np.testing.assert_allclose(g.p.cpu().numpy(), c.p.numpy(), rtol=0, atol=1e-6)
