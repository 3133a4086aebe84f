"""Exact k-nearest neighbours: the CUDA kernel ``csrc/knn.cu`` and its plain version.

``knn`` is the port's counterpart of ``glio_tpu.lidar.neighbors.knn`` (and of
the Pallas kernel ``glio_tpu.ops.knn_pallas``, a drop-in for it). On a CUDA
tensor it launches the kernel, or raises; on a CPU tensor it runs
``knn_reference``. Nothing falls back from one to the other.

``knn_pairs`` runs a batch of such problems over one stack of equal-sized
clouds, pair b querying frame ``i_idx[b]`` against the map of frame
``j_idx[b]`` (batch level 1's keyframe pairs), in one launch of the same
kernel; a batch takes the grid's y dimension, so at most 65,535 pairs go
in a call and more are refused. ``knn_pairs_reference`` is
``knn_reference`` applied pair by pair.

While span recording is on (``utils.profiling``), ``knn`` appends each
call's (Q, N, query_valid, points_valid) to its work counter, on the card
and on the CPU alike; ``knn_work`` sums the masks when it is read, after the
measured window, so the call itself adds no launch and no sync.

``knn_plan`` sizes the kernel's launch on the host: how many blocks of a
cluster share each 16-query tile and how the map is split between them
(``knn_splits`` lists the resulting map ranges). Both are plain integer
functions, so the CPU tests hold them to cover the map.
"""

import ctypes
import functools

import torch

from ..utils import profiling
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


def knn_plan(n_query: int, n_points: int, sm_count: int,
             batch: int = 1) -> tuple[int, int, int]:
    """The kernel's launch: ``(queries_per_block, cluster_size, points_per_split)``.

    Each tile of ``TILE_QUERIES`` queries is served by a cluster of
    ``cluster_size`` blocks, block r scanning the map points
    ``[r * points_per_split, (r + 1) * points_per_split)``, clipped to
    ``n_points``. Every split costs each query a fresh top-k warm-up, so the
    plan takes the fewest splits that give every SM a block, at most 8
    (``split_size`` sizes them); the tiles of all ``batch`` problems of a
    launch count, so a real batch runs clusters of one block. Raises
    ``ValueError`` for sizes the kernel's int32 indexing cannot hold. A
    plain tuple, as this runs on every launch.
    """
    if 3 * n_query >= 2**31 or 3 * n_points >= 2**31:
        raise ValueError("knn: sizes beyond the kernel's int32 indexing")
    tiles = batch * -(-n_query // TILE_QUERIES)
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
def _library(entry: str = "glio_knn5_f32", n_args: int = 11):
    fn = getattr(_build.load("knn.cu"), entry)
    # Every argument is a pointer or a size_t, 64 bits on the card's hosts;
    # ctypes converts a Python int fastest as c_void_p.
    fn.argtypes = [ctypes.c_void_p] * n_args
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
    if profiling.recording():
        _WORK.append((query.shape[0], points.shape[0], query_valid, points_valid))
    if not _launch.use_kernel("knn", query):
        return knn_reference(query, query_valid, points, points_valid, k)
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
    return out_d, out_i


_WORK = profiling.counter("knn")


def knn_work() -> list:
    """(Q, valid queries, N, valid points) of each ``knn`` call recorded
    since the last ``profiling.reset``; the masks are summed here (a host
    read each)."""
    return [(q, int(qv.sum()), n, int(pv.sum())) for q, n, qv, pv in _WORK]


# --- a batch of problems over one stack of clouds --------------------------------

MAX_PAIRS = 65535     # the grid's y dimension


def _check_pairs(world, world_valid, i_idx, j_idx):
    dev = world.device
    for name, t, dtype, ndim in (("world", world, torch.float32, 3),
                                 ("world_valid", world_valid, torch.bool, 2),
                                 ("i_idx", i_idx, torch.int64, 1),
                                 ("j_idx", j_idx, torch.int64, 1)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"knn_pairs: {name} must be a tensor")
        if t.device != dev:
            raise ValueError(f"knn_pairs: {name} is on {t.device}, world on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"knn_pairs: {name} must be {dtype}, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"knn_pairs: {name} must be {ndim}-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"knn_pairs: {name} must be contiguous")
    if world.shape[2] != 3 or world_valid.shape != world.shape[:2]:
        raise ValueError("knn_pairs: world must be (F, S, 3) and world_valid (F, S)")
    if i_idx.shape != j_idx.shape:
        raise ValueError("knn_pairs: i_idx and j_idx differ in length")
    if i_idx.shape[0] > MAX_PAIRS:
        raise ValueError(f"knn_pairs: {i_idx.shape[0]} pairs, at most {MAX_PAIRS} in a call")


def knn_pairs_reference(world, world_valid, i_idx, j_idx, k: int = 5):
    """``knn_reference`` of each pair: frame ``i_idx[b]``'s points against
    frame ``j_idx[b]``'s, once for each distinct pair. Returns (B, S, k)
    f32 and (B, S, k) int64."""
    S = world.shape[1]
    pairs, inverse = torch.unique(torch.stack([i_idx, j_idx]), dim=1, return_inverse=True)
    out_d = torch.empty((pairs.shape[1], S, k), dtype=torch.float32, device=world.device)
    out_i = torch.empty((pairs.shape[1], S, k), dtype=torch.int64, device=world.device)
    for b, (i, j) in enumerate(pairs.t().tolist()):
        out_d[b], out_i[b] = knn_reference(world[i], world_valid[i], world[j],
                                           world_valid[j], k)
    return out_d[inverse], out_i[inverse]


def knn_pairs(world, world_valid, i_idx, j_idx, k: int = 5):
    """k nearest valid points of frame ``j_idx[b]`` for each valid point of
    frame ``i_idx[b]``, for every pair b.

    Args: world (F, S, 3) f32 and world_valid (F, S) bool, every frame's
    cloud; i_idx, j_idx (B,) int64 frame indices in [0, F), B at most
    ``MAX_PAIRS``; contiguous, on one device. Returns (d2, idx): (B, S, k)
    f32 and (B, S, k) int64, indices into frame ``j_idx[b]``'s points, with
    ``knn``'s contract. On the card, one kernel launch; an index out of
    range is a device-side fault.
    """
    _check_pairs(world, world_valid, i_idx, j_idx)
    if not _launch.use_kernel("knn_pairs", world):
        return knn_pairs_reference(world, world_valid, i_idx, j_idx, k)
    if k != K_SUPPORTED:
        raise ValueError(f"knn_pairs: the CUDA kernel is built for k={K_SUPPORTED}, got k={k}")
    (F, S, _), B = world.shape, i_idx.shape[0]
    dev = world.device
    out_d = torch.empty((B, S, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, S, k), dtype=torch.int64, device=dev)
    if S == 0 or B == 0:
        return out_d, out_i
    index = world.get_device()
    _, cluster, split = knn_plan(S, S, _launch.sm_count(index), batch=B)
    _launch.launch("knn_pairs", _library("glio_knn5_pairs_f32", 12), index, world.data_ptr(),
                   world_valid.data_ptr(), i_idx.data_ptr(), j_idx.data_ptr(), F, S, B, cluster,
                   split, out_d.data_ptr(), out_i.data_ptr())
    return out_d, out_i
