"""Schur-complement marginalization prior (port of ``glio_tpu/solver/marginalization.py``).

The exact branch of the JAX function (``mixed_chol=False``): the dropped
block is eliminated with an eigen-clipped pseudo-inverse
(``MarginalizationFactor.cpp:176-201``) and the Schur complement is factored
by a Cholesky of A + EPS·I. Where that factor is not finite, the eigen
square root of the JAX package's fallback replaces it, selected on the
device. On the PSD systems of the window, the JAX main path's Tikhonov
elimination equals this branch to EPS-relative. """

from typing import NamedTuple

import torch

from .linalg import cholesky_or_nan


EPS = 1e-8   # eigenvalue clip and Cholesky floor, as in the JAX package


class MarginalPrior(NamedTuple):
    """residual(x) = sqrt_res + sqrt_jac @ local(x, x0) over the kept block."""
    sqrt_jac: torch.Tensor   # (n_keep, n_keep)
    sqrt_res: torch.Tensor   # (n_keep,)
    valid: torch.Tensor      # () bool, False until the first marginalization


def _clipped_inverse(A):
    """Pseudo-inverse of symmetric A with eigenvalues ≤ EPS treated as zero."""
    w, V = torch.linalg.eigh(A)
    ok = w > EPS
    inv_w = torch.where(ok, 1.0 / torch.where(ok, w, torch.ones_like(w)),
                        torch.zeros_like(w))
    return (V * inv_w) @ V.T


def marginalize(H, b, n_drop: int) -> MarginalPrior:
    """Schur-eliminate the leading n_drop tangent dims of (H, b).

    The returned (S, r0) satisfy SᵀS = H_schur and Sᵀr0 = b_schur
    (``MarginalizationFactor.cpp:203-231``).
    """
    H = 0.5 * (H + H.T)
    Hmm, Hmr = H[:n_drop, :n_drop], H[:n_drop, n_drop:]
    Hrm, Hrr = H[n_drop:, :n_drop], H[n_drop:, n_drop:]
    bm, br = b[:n_drop], b[n_drop:]

    Hmm_inv = _clipped_inverse(0.5 * (Hmm + Hmm.T))
    A = Hrr - Hrm @ Hmm_inv @ Hmr
    g = br - Hrm @ Hmm_inv @ bm

    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    L = cholesky_or_nan(0.5 * (A + A.T) + EPS * eye)
    S = L.T
    r0 = torch.linalg.solve_triangular(L, g[:, None], upper=False)[:, 0]

    # Eigen square root of the Schur complement, taken where the Cholesky
    # failed (marginalization.py:139-151 of the JAX package).
    w, V = torch.linalg.eigh(0.5 * (A + A.T))
    ok = w > EPS
    s = torch.sqrt(torch.where(ok, w, torch.ones_like(w)))
    Se = (V * torch.where(ok, s, torch.zeros_like(s))).T
    re = torch.where(ok, 1.0 / s, torch.zeros_like(s)) * (V.T @ g)
    bad = ~(torch.isfinite(S).all() & torch.isfinite(r0).all())
    return MarginalPrior(sqrt_jac=torch.where(bad, Se, S),
                         sqrt_res=torch.where(bad, re, r0),
                         valid=torch.ones((), dtype=torch.bool, device=H.device))
