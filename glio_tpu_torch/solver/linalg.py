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


def eigh3(a00, a01, a02, a11, a12, a22, sweeps: int = JACOBI_SWEEPS):
    """Eigen-decomposition of batched symmetric 3×3 matrices, given by their
    upper triangles (tensors of one shape), by cyclic Jacobi rotations.

    Returns (w, V): eigenvalues (..., 3) ascending and eigenvectors
    (..., 3, 3) as columns, in the entries' dtype. Every step is an
    elementwise add, multiply, divide or square root, correctly rounded on
    the CPU and the card alike, so both give the same bits, without the
    host sync (and the batch limits) of a library ``eigh``; a fixed number
    of sweeps keeps the work independent of the data. Small eigenvalues
    come out to high relative accuracy, as Jacobi's do.
    """
    A = [[a00, a01, a02], [a01, a11, a12], [a02, a12, a22]]
    one, zero = torch.ones_like(a00), torch.zeros_like(a00)
    V = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]
    for _ in range(sweeps):
        for p, q, r in ((0, 1, 2), (0, 2, 1), (1, 2, 0)):
            apq, app, aqq = A[p][q], A[p][p], A[q][q]
            off = apq == 0.0
            theta = (aqq - app) / (2.0 * torch.where(off, one, apq))
            sgn = torch.where(theta >= 0.0, one, -one)
            t = sgn / (torch.abs(theta) + torch.sqrt(theta * theta + 1.0))
            t = torch.where(off | torch.isinf(theta), zero, t)
            c = 1.0 / torch.sqrt(t * t + 1.0)
            s = t * c
            arp, arq = A[r][p], A[r][q]
            A[p][p] = app - t * apq
            A[q][q] = aqq + t * apq
            A[p][q] = A[q][p] = zero
            A[r][p] = A[p][r] = c * arp - s * arq
            A[r][q] = A[q][r] = s * arp + c * arq
            for k in range(3):
                vkp, vkq = V[k][p], V[k][q]
                V[k][p] = c * vkp - s * vkq
                V[k][q] = s * vkp + c * vkq
    d = torch.stack([A[0][0], A[1][1], A[2][2]], dim=-1)
    w, order = torch.sort(d, dim=-1, stable=True)
    Vm = torch.stack([torch.stack(row, dim=-1) for row in V], dim=-2)
    return w, torch.gather(Vm, -1, order[..., None, :].expand(Vm.shape))
