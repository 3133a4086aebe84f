"""Neighbour gathers and voxel downsampling (port of ``glio_tpu/lidar/neighbors.py:143-202``).

The k-NN search itself is ``glio_tpu_torch.ops.knn``: a CUDA kernel on the
card, its plain torch version on the CPU.
"""

import torch

# Splitmix64 multipliers as the signed int64 values of the same bit patterns:
# torch has no uint64 arithmetic, and int64 multiplication wraps mod 2^64.
_MIX1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MIX2 = 0x94D049BB133111EB - (1 << 64)
_INVALID_KEY = 1 << 62
_ORIGIN = 2048.0        # keeps voxel keys positive within ±2048 voxels


def _shr(x, s: int):
    """Logical right shift of int64 bit patterns (torch's ``>>`` is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def gather_neighbors(points, idx):
    """(..., Q, k, 3) neighbour coordinates; idx −1 gives zeros.

    points (N, 3) with idx (Q, k), or a batch: points (B, N, 3) with idx
    (B, Q, k) indexing each problem's own points."""
    safe = idx.clamp(min=0)
    if points.dim() == 2:
        out = points[safe]
    else:
        batch = torch.arange(points.shape[0], device=idx.device)
        out = points[batch.view(-1, *([1] * (idx.dim() - 1))), safe]
    return torch.where((idx >= 0)[..., None], out, torch.zeros_like(out))


def voxel_downsample(points, valid, voxel: float, max_out: int,
                     scatter_keys: bool = False):
    """First point of each voxel, in key order, into ``max_out`` rows.

    Quantize to voxel keys, stable-sort by key, keep the first point of
    each run, and compact into a fixed-size output with a validity mask
    (``pcl::VoxelGrid`` semantics up to first-point instead of centroid;
    see the JAX docstring for why). ``scatter_keys`` orders voxels by a
    bijective splitmix64 mix of the key, so that truncation at ``max_out``
    drops a spatially uniform subset. The output has a static shape and
    the function does not synchronise with the host.
    """
    dev = points.device
    # floor(points / voxel + origin) in f32, as the JAX package computes
    # it. The divisor is a broadcast tensor and not a Python scalar: CUDA's
    # division by a host scalar multiplies by its reciprocal, which rounds
    # differently from a true division.
    div = torch.tensor([voxel], dtype=points.dtype, device=dev).expand_as(points)
    key = torch.floor(points / div + _ORIGIN).to(torch.int64)
    packed = (key[:, 0] << 42) | (key[:, 1] << 21) | key[:, 2]
    if scatter_keys:
        m = packed * _MIX1
        m = m ^ _shr(m, 31)
        m = m * _MIX2
        packed = _shr(m, 4)
    packed = torch.where(valid, packed, torch.full_like(packed, _INVALID_KEY))
    sorted_key, order = torch.sort(packed, stable=True)
    first = torch.ones_like(valid)
    first[1:] = sorted_key[1:] != sorted_key[:-1]
    keep = first & (sorted_key < _INVALID_KEY)
    rank = torch.cumsum(keep.to(torch.int64), dim=0) - 1
    dest = torch.where(keep, rank, torch.full_like(rank, max_out)).clamp(max=max_out)
    # Rows past max_out, and every dropped point, land in the extra row.
    out = torch.zeros((max_out + 1, 3), dtype=points.dtype, device=dev)
    out[dest] = points[order]
    out_valid = torch.zeros((max_out + 1,), dtype=torch.bool, device=dev)
    out_valid[dest] = keep
    return out[:max_out], out_valid[:max_out]
