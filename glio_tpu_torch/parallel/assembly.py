"""The rank-local batch problem of ``optimize_batch_sharded`` (the JAX package
shards its assembly along time: ``glio_tpu/models/batch.py:825-864``).

A rank owns the keyframes [t0, t1) that ``spike_cr.partition`` gives it and
holds, on its own device, a slice of the problem: those keyframes and a halo
of H = max(R, 3) on each side, R = search_range (the relative rows reach R
keyframes ahead, the Doppler rows li − 1 .. li + 2), and only the epochs
whose rows touch an owned keyframe. Its assembly is the single-device
``_assemble_core_impl`` on the slice, of which it keeps the owned band and
gradient rows: every factor that touches an owned keyframe is in the slice,
in the same order, so those rows are the single-device band's. Three things
would put wrong numbers there without an error, and are handled here:

* the rolled relative pairs wrap at the slice's end: every local pair whose
  second keyframe is past it is masked;
* the Doppler rows clamp their keyframes to the slice's ends: the halo and
  the choice of epochs keep every clamp of an owned row at the trajectory's
  own ends;
* the IRLS weights are per factor: the weights of the slice's factors,
  derived at the current iterate, go to the rank's own trial cost.

Each factor is owned by the one rank that owns its first keyframe (the
relative rows) or its epoch's left keyframe ``ep_left`` (the DD and Doppler
rows); a rank's cost counts only those, so the partial costs sum to the
whole problem's over the ranks.
"""

import numpy as np
import torch

from ..models.batch import (F64, POSE_DOF, BatchProblem, _assemble_core_impl, _total_cost,
                            assembly_plan)
from .spike_cr import partition

KEYFRAME_LEAVES = ("p_odo", "q_odo", "rel_dp", "rel_dq", "rel_valid", "kf_time")
EPOCH_LEAVES = ("ep_left", "ep_ratio", "ep_valid", "sat_pos", "psr_rov", "psr_sta",
                "sv_valid", "system", "master", "whiten", "sat_vel", "sat_ddt", "dopp",
                "dopp_sigma", "elevation")


def halo(prob: BatchProblem) -> int:
    """Keyframes a rank holds on each side of its own: max(R, 3)."""
    return max(prob.rel_valid.shape[1], 3)


class RankShare:
    """Rank ``rank`` of ``n_ranks``'s slice of ``prob`` (the whole problem,
    on any device; the slice is copied to ``device``).

    ``prob`` is None for a rank that owns no keyframes (identity padding of
    the solve only). Otherwise: ``prob`` the local problem (keyframes
    [start, start + T_l), its epochs ``epochs`` of the whole problem's, in
    their order, ``ep_left`` shifted by ``start``); ``rows`` the owned
    keyframes in local indices; ``own_rel`` (T_l,) and ``own_ep`` (E_l,) the
    0 / 1 masks of the factors it owns; ``plan`` its ``assembly_plan``.
    """

    def __init__(self, prob: BatchProblem, hw: int, rank: int, n_ranks: int,
                 use_doppler: bool, device):
        T = prob.p_odo.shape[0]
        self.hw, self.use_doppler = hw, use_doppler
        self.part = part = partition(T, hw, rank, n_ranks)
        self.prob = None
        if part.t1 == part.t0:
            return
        H = halo(prob)
        a, b = max(part.t0 - H, 0), min(part.t1 + H, T)
        self.start = a
        self.rows = slice(part.t0 - a, part.t1 - a)
        # The DD rows of pair (li, li + 1) touch an owned keyframe for
        # li ∈ [t0 − 1, t1), the Doppler rows of li − 1 .. li + 2 for
        # li ∈ [t0 − 2, t1].
        left = prob.ep_left.cpu().numpy()
        lo, hi = (part.t0 - 2, part.t1 + 1) if use_doppler else (part.t0 - 1, part.t1)
        self.epochs = np.nonzero((left >= lo) & (left < hi))[0]
        ep = torch.as_tensor(self.epochs, device=prob.ep_left.device)
        leaves = {}
        for name, x in prob._asdict().items():
            if name in KEYFRAME_LEAVES:
                x = x[a:b]
            elif name in EPOCH_LEAVES:
                x = x[ep]
            leaves[name] = x.to(device)
        leaves["ep_left"] = leaves["ep_left"] - a
        # A pair (i, i + r + 1) past the slice's end would wrap onto its
        # first keyframes.
        T_l = b - a
        R = prob.rel_valid.shape[1]
        ahead = (torch.arange(T_l, device=device)[:, None]
                 + torch.arange(1, R + 1, device=device)[None, :])
        leaves["rel_valid"] = leaves["rel_valid"] & (ahead < T_l)
        self.prob = BatchProblem(**leaves)
        i = torch.arange(T_l, device=device)
        self.own_rel = ((i >= self.rows.start) & (i < self.rows.stop)).to(F64)
        own_ep = (left[self.epochs] >= part.t0) & (left[self.epochs] < part.t1)
        self.own_ep = torch.as_tensor(own_ep, device=device).to(F64)
        self.plan = assembly_plan(self.prob, hw, use_doppler)

    def _local(self, x):
        return x[self.start:self.start + self.prob.p_odo.shape[0]]

    def assemble(self, p, q, threshold, robust):
        """The owned band rows (t1 − t0, 2hw+1, D, D) and gradient rows at the
        whole trajectory (p, q), the owned factors' cost and the slice's
        IRLS weights derived at (p, q) under ``robust``
        (``_assemble_core_impl``'s, on the slice)."""
        if self.prob is None:
            D = POSE_DOF
            return (torch.zeros((0, 2 * self.hw + 1, D, D), dtype=F64, device=p.device),
                    torch.zeros((0, D), dtype=F64, device=p.device),
                    torch.zeros((), dtype=F64, device=p.device), None, None)
        band, grad, cost, w_rel, w_dd = _assemble_core_impl(
            self._local(p), self._local(q), self.prob, threshold, self.hw, robust=robust,
            plan=self.plan, use_doppler=self.use_doppler, own=(self.own_rel, self.own_ep))
        return band[self.rows], grad[self.rows], cost, w_rel, w_dd

    def cost(self, p, q, threshold, w_rel=None, w_dd=None):
        """The owned factors' cost at the whole trajectory (p, q), under the
        slice's weights where given (``_total_cost``)."""
        if self.prob is None:
            return torch.zeros((), dtype=F64, device=p.device)
        return _total_cost(self._local(p), self._local(q), self.prob, threshold, w_rel, w_dd,
                           self.use_doppler, own=(self.own_rel, self.own_ep))
