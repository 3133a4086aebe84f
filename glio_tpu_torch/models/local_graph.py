"""Dense inter-keyframe trajectory interpolation (port of ``glio_tpu/models/local_graph.py:28-101``).

The reference's local pose graph (``Estimator::optimizeLocalGraph``,
Estimator.cpp:3452-3527): the 10 Hz non-key frames between two keyframes
are refined by a small chain anchored at both keyframes, with relative-pose
measurements between consecutive frames, all at weight 0.2
(LidarPoseFactor.h:33-38, 150-155). Every segment is independent, so all
T − 1 of them are solved by one batched LM (``dense.lm_solve_batched``), as
the JAX package vmaps one ``lm_solve``.
"""

from typing import NamedTuple

import torch

from ..solver import dense
from ..utils import quat

W_CHAIN = 0.2


class Frames(NamedTuple):
    p: torch.Tensor   # (S, n_int, 3)
    q: torch.Tensor   # (S, n_int, 4)


def interpolate_segments(kf_p, kf_q, rel_dp, rel_dq, rel_valid, max_dense: int = 4,
                         iters: int = 6):
    """Refine the dense frames between consecutive keyframes.

    kf_p (T, 3), kf_q (T, 4): keyframe poses; rel_dp, rel_dq
    (T-1, max_dense+1, 3 / 4): measured hops j → j+1 of each segment, frame
    0 the left keyframe; rel_valid (T-1, max_dense+1): hop validity, packed
    from slot 0, so a segment's hop count is its valid count, and a segment
    with fewer hops ties the right keyframe at chain position n_hops.

    Returns (p_dense (T-1, max_dense, 3), q_dense (T-1, max_dense, 4),
    valid (T-1, max_dense)).
    """
    n_int = max_dense
    pl, ql, pr, qr = kf_p[:-1], kf_q[:-1], kf_p[1:], kf_q[1:]
    n_seg = pl.shape[0]
    n_hops = rel_valid.to(torch.int64).sum(dim=1)

    # Initial guess: chain the measured hops from the left keyframe.
    p_c, q_c = pl, ql
    p0s, q0s = [], []
    for k in range(n_int):
        ok = rel_valid[:, k, None]
        p_c = torch.where(ok, p_c + quat.rotate(q_c, rel_dp[:, k]), p_c)
        q_c = torch.where(ok, quat.normalize(quat.mul(q_c, rel_dq[:, k])), q_c)
        p0s.append(p_c)
        q0s.append(q_c)
    x0 = Frames(torch.stack(p0s, dim=1), torch.stack(q0s, dim=1))

    chain = torch.arange(n_int + 2, device=kf_p.device)
    at_right = (chain[None, :] == n_hops[:, None])[..., None]       # (S, n_int+2, 1)

    def residual(x: Frames):
        # [left kf, interior..., right kf], the right keyframe substituted
        # at position n_hops (the padded end when the segment is full).
        ps = torch.cat([pl[:, None], x.p, pr[:, None]], dim=1)
        qs = torch.cat([ql[:, None], x.q, qr[:, None]], dim=1)
        ps = torch.where(at_right, pr[:, None], ps)
        qs = torch.where(at_right, qr[:, None], qs)
        rq = 2.0 * quat.mul(quat.conj(rel_dq),
                            quat.mul(quat.conj(qs[:, :-1]), qs[:, 1:]))[..., 1:]
        rp = quat.rotate(quat.conj(qs[:, :-1]), ps[:, 1:] - ps[:, :-1]) - rel_dp
        r = torch.cat([rq, rp], dim=-1)
        r = torch.where(rel_valid[..., None], r, torch.zeros_like(r))
        return (W_CHAIN * r).reshape(n_seg, -1)

    def retract(x: Frames, d):
        dd = d.reshape(n_seg, n_int, 6)
        return Frames(x.p + dd[..., :3], quat.normalize(quat.mul(x.q, quat.exp(dd[..., 3:6]))))

    out = dense.lm_solve_batched(residual, retract, x0, n_int * 6, max_iters=iters)
    return out.x.p, out.x.q, rel_valid[:, 1:]
