"""Small dense solves (port of ``glio_tpu/solver/linalg.py``).

The H100 has native f64, so there is no counterpart of the JAX package's
f32-Cholesky-with-refinement helpers, which exist because TPU f64 is
emulated.
"""

import torch


def cholesky_or_nan(A):
    """Lower Cholesky factor of A, or NaN where A is not positive definite.

    JAX's Cholesky returns NaN on such a matrix and the solvers rely on it
    (LM rejects the step, marginalization takes its fallback);
    ``torch.linalg.cholesky`` raises instead, and would need a host sync to
    do so. ``cholesky_ex`` reports failure in ``info`` on the device.
    """
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def spd_solve(H, b):
    """Solve H x = b for symmetric positive-definite H (..., n, n): b is a
    vector (..., n) or, with as many axes as H, a matrix (..., n, k)."""
    L = cholesky_or_nan(H)
    vector = b.dim() == H.dim() - 1
    y = torch.linalg.solve_triangular(L, b[..., None] if vector else b, upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)
    return x[..., 0] if vector else x


def solve_3x3(A, b, eps: float):
    """Closed-form batched solve of (A + eps·I) x = b by adjugate and determinant."""
    A = A + eps * torch.eye(3, dtype=A.dtype, device=A.device)
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / torch.where(det.abs() < 1e-30, torch.ones_like(det), det)
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + c10 * b1 + c20 * b2) * inv_det
    x1 = (c01 * b0 + c11 * b1 + c21 * b2) * inv_det
    x2 = (c02 * b0 + c12 * b1 + c22 * b2) * inv_det
    return torch.stack([x0, x1, x2], dim=-1)


JACOBI_SWEEPS = 6   # a 3×3 symmetric matrix converges to f64 round-off in 4
