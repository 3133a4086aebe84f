"""The plain k-NN of the port's ``ops/knn.py`` (``knn_reference``), as ``knn``."""

import torch

_CHUNK = 2048


def knn(query, query_valid, points, points_valid, k: int = 5):
    """Plain torch k-NN, one map chunk at a time.

    Distances are ``(dx*dx + dy*dy) + dz*dz`` as separate elementwise ops
    (no fused multiply-add). Each chunk's candidates are appended after the
    running best list, whose indices are all lower, and k rounds of
    ``argmin`` (which returns the first minimum) keep ties on the lowest
    index. Returns (Q, k) f32 squared distances (inf where missing) and
    (Q, k) int64 indices (-1 where missing).
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

