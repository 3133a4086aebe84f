"""Operations and bytes of the port's kernels, and the card's published peaks.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no sparsity):
67 TFLOP/s of float32 outside the tensor cores and 3.35 TB/s of HBM3. They
assume the full 700 W; the run reads the card's power limit beside them.
"""

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

KNN_FLOPS_PER_PAIR = 8      # 3 differences, 3 squares, 2 sums: (dx*dx + dy*dy) + dz*dz
KNN_K = 5


def knn_work(n_query: int, n_query_valid: int, n_points: int, n_points_valid: int,
             k: int = KNN_K) -> tuple:
    """(operations, bytes) that one 5-NN call over these inputs needs.

    Every valid query is compared with every valid map point; the selection
    of the k best is not counted. Bytes: the valid queries' and points'
    coordinates (3 float32 each) and both masks (a byte an entry) read once,
    and for every query k float32 distances and k int64 indices written.
    """
    flops = KNN_FLOPS_PER_PAIR * n_query_valid * n_points_valid
    read = 12 * (n_query_valid + n_points_valid) + n_query + n_points
    write = n_query * k * (4 + 8)
    return flops, read + write


def least_time_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)
