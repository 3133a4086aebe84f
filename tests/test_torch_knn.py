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

The kernel splits the map between the blocks of a cluster (``knn_plan``,
``knn_splits``) and merges the partial top-k lists by (distance, index). Its arithmetic runs only on the card, but the split and
the merge do not need it: ``knn_reference`` on each split, merged so, must
equal ``knn_reference`` on the whole map bit for bit.

The CUDA kernel itself is tested on the card by ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glio_tpu.lidar import neighbors as jnb
from glio_tpu.ops.knn_pallas import knn_pallas
from glio_tpu_torch.ops import knn as tknn
from glio_tpu_torch.utils import profiling

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
    before = profiling.tallies().get("knn.launches", 0)
    tknn.knn(torch.zeros((4, 3)), torch.ones(4, dtype=torch.bool),
             torch.ones((8, 3)), torch.ones(8, dtype=torch.bool))
    assert profiling.tallies().get("knn.launches", 0) == before



PLAN_SHAPES = {   # name: (queries, map points, SMs)
    "main_path": (5120, 16384, 132),
    "sms1_pair": (1024, 1024, 132),
    "odometry_bench_scan": (1024, 16384, 132),        # lidar_odometry.py: MAP_DS
    "odometry_production_scan": (2048, 16384, 132),
    "empty_map": (5120, 0, 132),
    "map_below_cluster_size": (100, 5, 132),
    "map_below_4_points": (100, 3, 132),
    "ragged_both": (5119, 16381, 132),
    "one_query": (1, 777, 132),
    "few_sms": (300, 3000, 8),
    "large_queries": (17000, 16384, 132),
}


@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
def test_knn_plan_covers_the_map_once(shape):
    Q, N, sms = PLAN_SHAPES[shape]
    plan = tknn.knn_plan(Q, N, sms)
    per_tile, cluster, split = plan
    assert per_tile == tknn.TILE_QUERIES and per_tile % cluster == 0
    assert cluster in tknn.CLUSTER_SIZES and split >= 0
    assert split <= N and cluster * split >= N
    ranges = tknn.knn_splits(N, plan)
    assert len(ranges) == cluster
    covered = np.concatenate([np.arange(lo, hi) for lo, hi in ranges] + [np.zeros(0, int)])
    np.testing.assert_array_equal(covered, np.arange(N))    # ascending, contiguous, once
    assert all(lo <= hi for lo, hi in ranges)
    assert all(hi - lo == split for lo, hi in ranges if hi < N)   # only the tail is short
    if cluster > 1 and split < N:     # every split starts 16-byte aligned
        assert split % 4 == 0
    tiles = -(-Q // per_tile)
    # The fewest splits that give every SM a block, at most 8.
    assert tiles * cluster >= sms or cluster == 8
    assert cluster == 1 or tiles * cluster // 2 < sms
    expected = {"main_path": 1, "odometry_bench_scan": 4, "odometry_production_scan": 2,
                "sms1_pair": 4}
    if shape in expected:
        assert cluster == expected[shape]


@pytest.mark.parametrize("sizes", [(2**31 // 3 + 1, 16), (16, 2**31 // 3 + 1)])
def test_knn_plan_rejects_sizes_beyond_int32_indexing(sizes):
    """The kernel indexes coordinates (3 per point) in int32; the wrapper
    plans every launch, so this is its check."""
    with pytest.raises(ValueError):
        tknn.knn_plan(*sizes, 132)
    assert tknn.knn_plan(2**31 // 3, 2**31 // 3, 132)[1] == 1


def _merge(lists, k=5):
    """The kernel's merge: the first k of the union by (distance, index)."""
    d = torch.cat([a for a, _ in lists], dim=1)
    i = torch.cat([b for _, b in lists], dim=1)
    key_i = torch.where(i < 0, torch.iinfo(torch.int64).max, i)
    order = np.lexsort((key_i.numpy(), d.numpy()), axis=1)[:, :k]
    order = torch.from_numpy(order)
    return torch.gather(d, 1, order), torch.gather(i, 1, order)


def _split_merge(q, qv, p, pv, plan):
    lists = []
    for lo, hi in tknn.knn_splits(p.shape[0], plan):
        d, i = tknn.knn_reference(q, qv, p[lo:hi], pv[lo:hi])
        lists.append((d, torch.where(i >= 0, i + lo, i)))
    return _merge(lists)


def _lattice(rng, n):
    return (rng.integers(-2, 3, size=(n, 3)) + [300, -80, 2]).astype(F32)


SPLIT_CASES = {   # name: rng -> (q, qv, p, pv); ties are exact wherever named
    "cloud": lambda r: (_lattice(r, 40) + r.normal(size=(40, 3)).astype(F32),
                        r.uniform(size=40) < 0.9, _lattice(r, 3000) + r.normal(
                            size=(3000, 3)).astype(F32), r.uniform(size=3000) < 0.9),
    "lattice_ties_everywhere": lambda r: (_lattice(r, 60), np.ones(60, bool), _lattice(r, 3000),
                                          r.uniform(size=3000) < 0.8),
    "twin_in_the_next_split": lambda r: (lambda c: (c[:50], np.ones(50, bool),
                                                    np.concatenate([c, c]),
                                                    np.ones(2 * len(c), bool)))(
        _lattice(r, 1500) + r.normal(size=(1500, 3)).astype(F32)),
    "equal_distances_straddle_a_boundary": lambda r: _straddle(),
    "all_invalid": lambda r: (_lattice(r, 20), np.ones(20, bool), _lattice(r, 700),
                              np.zeros(700, bool)),
    "map_below_k": lambda r: (_lattice(r, 20), np.ones(20, bool), _lattice(r, 3),
                              np.ones(3, bool)),
}


def _straddle():
    """Points at distance 1 from the origin query on both sides of every
    multiple of 128 in a 1024-point map: each split boundary of 2, 4 or 8
    splits."""
    p = np.full((1024, 3), 50.0, F32)
    units = np.concatenate([np.eye(3), -np.eye(3)]).astype(F32)
    for b in range(128, 1024, 128):
        p[b - 2:b + 2] = units[(b // 128) % 6]
    return np.zeros((3, 3), F32), np.ones(3, bool), p, np.ones(1024, bool)


@pytest.mark.parametrize("cluster", ["plan", 2, 8])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_and_merge_equals_whole_map(case, cluster):
    q, qv, p, pv = (torch.tensor(a) for a in SPLIT_CASES[case](np.random.default_rng(0)))
    N = p.shape[0]
    plan = tknn.knn_plan(q.shape[0], N, 132)
    if cluster != "plan":
        plan = (plan[0], cluster, -(-N // cluster))
    d_m, i_m = _split_merge(q, qv, p, pv, plan)
    d_r, i_r = tknn.knn_reference(q, qv, p, pv)
    assert torch.equal(i_m, i_r) and torch.equal(d_m, d_r)
    if case == "equal_distances_straddle_a_boundary":
        assert d_r[0].tolist() == [1.0] * 5 and i_r[0].tolist() == [126, 127, 128, 129, 254]
