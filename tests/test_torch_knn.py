"""Port parity: the k-NN search.

On the CPU, ``knn`` runs its plain version ``knn_reference``; both are held
against ``glio_tpu.lidar.neighbors.knn`` and the Pallas kernel
``knn_pallas`` in interpret mode. Neighbour indices are compared as sets
(the JAX functions break ties arbitrarily) and distances to rtol 1e-5
(f32, and XLA may contract the squares with fused multiply-adds).
``knn_pallas`` forms ‖q‖² + ‖p‖² − 2q·p, whose f32 rounding is relative
to ‖q‖² + ‖p‖², so its distances get that absolute floor (4 ulp of it),
and at world-scale coordinates that error reorders near neighbours
(neighbors.py:25-27): the 300 m window case is held against
``neighbors.knn`` only.

The CUDA kernel itself is tested on the card by ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glio_tpu.lidar import neighbors as jnb
from glio_tpu.ops.knn_pallas import knn_pallas
from glio_tpu_torch.ops import knn as tknn

F32 = np.float32


def _brute_force(rng):
    q = (rng.normal(size=(300, 3)) * 10).astype(F32)
    p = (rng.normal(size=(3000, 3)) * 10).astype(F32)
    return q, np.ones(300, bool), p, np.ones(3000, bool), 5


def _masks(rng):
    p = np.zeros((8, 3), F32)
    p[0] = [0, 0, 0.1]
    p[1] = [0, 0, 1.0]
    p[2:] = 50.0
    pv = np.ones(8, bool)
    pv[0] = False                      # nearest but invalid
    return np.zeros((2, 3), F32), np.array([True, False]), p, pv, 2


def _padding(rng):
    q = rng.normal(size=(77, 3)).astype(F32)
    p = rng.normal(size=(333, 3)).astype(F32)
    return q, np.ones(77, bool), p, np.ones(333, bool), 3


def _window_vs_voxel_map(rng):
    """Two window frames (2 × 256 points) against a 2048-point voxelled map
    ~300 m from the origin, with invalid points on both sides."""
    ring = (rng.uniform(-25, 25, size=(8 * 256, 3)) + [300.0, -80.0, 0.0]).astype(F32)
    ring_valid = rng.uniform(size=ring.shape[0]) > 0.1
    pts, pv = jnb.voxel_downsample(jnp.asarray(ring), jnp.asarray(ring_valid), 0.4,
                                   2048, scatter_keys=True)
    q = (ring[:512] + rng.normal(size=(512, 3)) * 0.3).astype(F32)
    qv = rng.uniform(size=512) > 0.1
    return q, qv, np.asarray(pts), np.asarray(pv), 5


CASES = {"brute_force": _brute_force, "masks": _masks, "padding": _padding,
         "window_vs_voxel_map": _window_vs_voxel_map}
PORT = {"reference": tknn.knn_reference, "wrapper_cpu": tknn.knn}


def _jax_results(case, q, qv, p, pv, k):
    """(d2, idx, absolute distance floor) of each JAX function."""
    args = (jnp.asarray(q), jnp.asarray(qv), jnp.asarray(p), jnp.asarray(pv))
    out = {"neighbors.knn": (*jnb.knn(*args, k=k), 1e-6)}
    if case != "window_vs_voxel_map":
        floor = 4 * np.finfo(F32).eps * float((q ** 2).sum(1).max() + (p ** 2).sum(1).max())
        out["knn_pallas"] = (*knn_pallas(*args, k=k, query_tile=64, map_tile=256,
                                         interpret=True), floor)
    return out


@pytest.mark.parametrize("port", sorted(PORT))
@pytest.mark.parametrize("case", sorted(CASES))
def test_knn_matches_jax(case, port):
    q, qv, p, pv, k = CASES[case](np.random.default_rng(0))
    d_t, i_t = PORT[port](torch.tensor(q), torch.tensor(qv), torch.tensor(p),
                          torch.tensor(pv), k=k)
    assert d_t.dtype == torch.float32 and i_t.dtype == torch.int64
    d_t, i_t = d_t.numpy(), i_t.numpy()
    assert np.all(d_t[:, 1:] >= d_t[:, :-1])                  # sorted ascending
    assert np.all((i_t >= 0) == np.isfinite(d_t))
    assert np.all(i_t[~qv] == -1) and np.all(np.isinf(d_t[~qv]))
    for name, (d_j, i_j, floor) in _jax_results(case, q, qv, p, pv, k).items():
        d_j, i_j = np.asarray(d_j), np.asarray(i_j)
        for a, b in zip(i_t[qv], i_j[qv]):
            assert set(a[a >= 0]) == set(b[b >= 0]), name
        fin = np.isfinite(d_t)
        np.testing.assert_array_equal(fin, d_j < 3e38, err_msg=name)
        np.testing.assert_allclose(d_t[fin], d_j[fin], rtol=1e-5, atol=floor,
                                   err_msg=name)


def test_knn_ties_go_to_lowest_index():
    p = np.array([[1, 0, 0], [0, 1, 0], [-1, 0, 0], [0, -1, 0], [0, 0, 1],
                  [0, 0, -1], [2, 0, 0]], F32)
    d, i = tknn.knn(torch.zeros((1, 3)), torch.ones(1, dtype=torch.bool),
                    torch.tensor(p), torch.ones(7, dtype=torch.bool), k=5)
    assert i.tolist() == [[0, 1, 2, 3, 4]]
    assert d.tolist() == [[1.0] * 5]


def test_knn_fewer_valid_points_than_k():
    p = torch.tensor(np.random.default_rng(1).normal(size=(64, 3)).astype(F32))
    pv = torch.zeros(64, dtype=torch.bool)
    pv[[5, 17, 40]] = True
    d, i = tknn.knn(torch.zeros((4, 3)), torch.ones(4, dtype=torch.bool), p, pv)
    assert set(i[0, :3].tolist()) == {5, 17, 40}
    assert (i[:, 3:] == -1).all() and torch.isinf(d[:, 3:]).all()


@pytest.mark.parametrize("bad", ["dtype", "shape", "mask_length", "contiguous",
                                 "device_mix"])
def test_knn_wrapper_rejects_bad_input(bad):
    q = torch.zeros((10, 3))
    qv = torch.ones(10, dtype=torch.bool)
    p = torch.zeros((20, 3))
    pv = torch.ones(20, dtype=torch.bool)
    if bad == "dtype":
        q = q.double()
    elif bad == "shape":
        p = torch.zeros((20, 4))
    elif bad == "mask_length":
        pv = pv[:19]
    elif bad == "contiguous":
        q = torch.zeros((3, 10)).T
    elif bad == "device_mix":
        p = torch.zeros((20, 3), device="meta")
    with pytest.raises((TypeError, ValueError)):
        tknn.knn(q, qv, p, pv)


def test_cpu_path_does_not_count_launches():
    before = tknn.knn.launches
    tknn.knn(torch.zeros((4, 3)), torch.ones(4, dtype=torch.bool),
             torch.ones((8, 3)), torch.ones(8, dtype=torch.bool))
    assert tknn.knn.launches == before

