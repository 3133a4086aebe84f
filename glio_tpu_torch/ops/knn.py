"""Exact k-nearest neighbours: the CUDA kernel ``csrc/knn.cu`` and its plain version.

``knn`` is the port's counterpart of ``glio_tpu.lidar.neighbors.knn`` (and of
the Pallas kernel ``glio_tpu.ops.knn_pallas``, a drop-in for it). On a CUDA
tensor it launches the kernel, or raises; on a CPU tensor it runs
``knn_reference``. Nothing falls back from one to the other.

``knn_plan`` sizes the kernel's launch on the host: how many blocks of a
cluster share each 16-query tile and how the map is split between them
(``knn_splits`` lists the resulting map ranges). Both are plain integer
functions, so the CPU tests hold them to cover the map.
"""

import ctypes
import functools

import torch

from . import _build, _launch

K_SUPPORTED = 5
_CHUNK = 2048


def _check(query, query_valid, points, points_valid):
    dev = query.device
    for name, t, dtype, ndim in (("query", query, torch.float32, 2),
                                 ("query_valid", query_valid, torch.bool, 1),
                                 ("points", points, torch.float32, 2),
                                 ("points_valid", points_valid, torch.bool, 1)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"knn: {name} must be a tensor")
        if t.device != dev:
            raise ValueError(f"knn: {name} is on {t.device}, query on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"knn: {name} must be {dtype}, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"knn: {name} must be {ndim}-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"knn: {name} must be contiguous")
    if query.shape[1] != 3 or points.shape[1] != 3:
        raise ValueError("knn: query and points must be (n, 3)")
    if query_valid.shape[0] != query.shape[0] or points_valid.shape[0] != points.shape[0]:
        raise ValueError("knn: a validity mask does not match its points")


def knn_reference(query, query_valid, points, points_valid, k: int = 5):
    """Plain torch k-NN with the kernel's contract, one map chunk at a time.

    Distances are ``(dx*dx + dy*dy) + dz*dz`` as separate elementwise ops
    (no fused multiply-add). Each chunk's candidates are appended after the
    running best list, whose indices are all lower, and k rounds of
    ``argmin`` (which returns the first minimum) keep ties on the lowest
    index.
    """
    Q, dev = query.shape[0], query.device
    best_d = torch.full((Q, k), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((Q, k), -1, dtype=torch.int64, device=dev)
    qx, qy, qz = (query[:, c:c + 1] for c in range(3))
    for start in range(0, points.shape[0], _CHUNK):
        p = points[start:start + _CHUNK]
        dx, dy, dz = qx - p[:, 0], qy - p[:, 1], qz - p[:, 2]
        d = (dx * dx + dy * dy) + dz * dz
        d = torch.where(points_valid[start:start + _CHUNK], d,
                        torch.full_like(d, float("inf")))
        cand_d = torch.cat([best_d, d], dim=1)
        idx = torch.arange(start, start + p.shape[0], device=dev)
        cand_i = torch.cat([best_i, idx.expand(Q, -1)], dim=1)
        picks_d, picks_i = [], []
        for _ in range(k):
            a = torch.argmin(cand_d, dim=1, keepdim=True)
            picks_d.append(torch.gather(cand_d, 1, a))
            picks_i.append(torch.gather(cand_i, 1, a))
            cand_d = cand_d.scatter(1, a, float("inf"))
        best_d = torch.cat(picks_d, dim=1)
        best_i = torch.cat(picks_i, dim=1)
    ok = query_valid[:, None] & torch.isfinite(best_d)
    best_d = torch.where(query_valid[:, None], best_d, torch.full_like(best_d, float("inf")))
    best_i = torch.where(ok, best_i, torch.full_like(best_i, -1))
    return best_d, best_i


# The kernel's shape (csrc/knn.cu: kTileQueries, kMaxCluster).
TILE_QUERIES = 16                # queries a cluster serves: 8 warps x 2
CLUSTER_SIZES = (1, 2, 4, 8)     # powers of two up to the portable 8


def split_size(n_points: int, cluster: int) -> int:
    """Points per block when ``cluster`` blocks share ``n_points``: a
    multiple of 4 when the map is split (unless the map has fewer), so every
    split starts 16-byte aligned for the kernel's staging loads."""
    if cluster == 1:
        return n_points
    return min(n_points, -(-n_points // (4 * cluster)) * 4)


def knn_plan(n_query: int, n_points: int, sm_count: int) -> tuple[int, int, int]:
    """The kernel's launch: ``(queries_per_block, cluster_size, points_per_split)``.

    Each tile of ``TILE_QUERIES`` queries is served by a cluster of
    ``cluster_size`` blocks, block r scanning the map points
    ``[r * points_per_split, (r + 1) * points_per_split)``, clipped to
    ``n_points``. Every split costs each query a fresh top-k warm-up, so the
    plan takes the fewest splits that give every SM a block, at most 8
    (``split_size`` sizes them). Raises ``ValueError`` for sizes the
    kernel's int32 indexing cannot hold. A plain tuple, as this runs on
    every launch.
    """
    if 3 * n_query >= 2**31 or 3 * n_points >= 2**31:
        raise ValueError("knn: sizes beyond the kernel's int32 indexing")
    tiles = -(-n_query // TILE_QUERIES)
    cluster = next((c for c in CLUSTER_SIZES if tiles * c >= sm_count), CLUSTER_SIZES[-1])
    return TILE_QUERIES, cluster, split_size(n_points, cluster)


def knn_splits(n_points: int, plan: tuple[int, int, int]) -> list[tuple[int, int]]:
    """The map ranges ``[lo, hi)`` that the blocks of one cluster scan, in
    rank order; the kernel computes the same bounds. A range may be empty."""
    _, cluster, split = plan
    out = []
    for rank in range(cluster):
        lo = min(rank * split, n_points)
        out.append((lo, min(lo + split, n_points)))
    return out


@functools.cache
def _library():
    fn = _build.load("knn.cu").glio_knn5_f32
    # Every argument is a pointer or a size_t, 64 bits on the card's hosts;
    # ctypes converts a Python int fastest as c_void_p.
    fn.argtypes = [ctypes.c_void_p] * 11
    fn.restype = ctypes.c_int
    return fn


def knn(query, query_valid, points, points_valid, k: int = 5):
    """k nearest valid ``points`` of each valid query.

    Args: query (Q, 3) f32, query_valid (Q,) bool, points (N, 3) f32,
    points_valid (N,) bool, contiguous, all on one device.
    Returns (d2, idx): (Q, k) f32 squared distances ascending (inf where
    missing) and (Q, k) int64 indices into ``points`` (−1 where missing).
    """
    _check(query, query_valid, points, points_valid)
    if not query.is_cuda:
        if query.device.type == "cpu":
            return knn_reference(query, query_valid, points, points_valid, k)
        raise ValueError(f"knn: no kernel for device {query.device}")
    if k != K_SUPPORTED:
        raise ValueError(f"knn: the CUDA kernel is built for k={K_SUPPORTED}, got k={k}")
    Q, N = query.shape[0], points.shape[0]
    index = query.get_device()
    _, cluster, split = knn_plan(Q, N, _launch.sm_count(index))
    dev = query.device
    out_d = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int64, device=dev)
    _launch.launch("knn", _library(), index, query.data_ptr(), query_valid.data_ptr(),
                   points.data_ptr(), points_valid.data_ptr(), Q, N, cluster, split,
                   out_d.data_ptr(), out_i.data_ptr())
    knn.launches += 1
    return out_d, out_i


knn.launches = 0
