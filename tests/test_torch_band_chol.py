"""The f32 block-banded Cholesky factor's and solve's kernel wrappers
(``ops/band_chol.py``) on the CPU: their route to the plain versions and
their input checks. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from glio_tpu_torch.ops import band_chol
from glio_tpu_torch.solver import banded


def _band(T=12, hw=3, D=6, seed=0):
    """An SPD band: Jᵀ J + I with rows of J spanning hw + 1 block columns."""
    rng = np.random.default_rng(seed)
    n = T * D
    J = np.zeros((2 * n, n))
    for r in range(2 * n):
        c = rng.integers(0, n - hw * D)
        J[r, c:c + hw * D] = rng.normal(size=hw * D)
    H = J.T @ J + np.eye(n)
    band = np.zeros((T, 2 * hw + 1, D, D))
    for t in range(T):
        for o in range(2 * hw + 1):
            j = t + o - hw
            if 0 <= j < T:
                band[t, o] = H[t * D:(t + 1) * D, j * D:(j + 1) * D]
    return torch.tensor(band, dtype=torch.float32)


def test_band_cholesky_on_cpu_is_block_cholesky():
    band = _band()
    before = band_chol.band_cholesky.launches
    L = band_chol.band_cholesky(band, 3e-4)
    assert band_chol.band_cholesky.launches == before      # no kernel on the CPU
    assert torch.equal(L, banded.block_cholesky(band, jitter=3e-4))
    dense = torch.zeros((72, 72))
    for t in range(12):
        for m in range(4):
            if t - m >= 0:
                dense[6 * t:6 * t + 6, 6 * (t - m):6 * (t - m) + 6] = L[t, m]
    A = torch.zeros((72, 72))
    for t in range(12):
        for o in range(7):
            j = t + o - 3
            if 0 <= j < 12:
                A[6 * t:6 * t + 6, 6 * j:6 * j + 6] = band[t, o]
    A += 3e-4 * torch.eye(72)
    assert (dense @ dense.T - A).abs().max() <= 1e-4 * A.abs().max()


@pytest.mark.parametrize("case", ["f64", "even_width", "not_square", "strided"])
def test_band_cholesky_checks_its_input(case):
    band = _band()
    bad = {"f64": band.double(), "even_width": band[:, :6], "not_square": band[..., :5],
           "strided": band[::2]}[case]
    err = TypeError if case == "f64" else ValueError
    with pytest.raises(err):
        band_chol.band_cholesky(bad, 3e-4)


def _solve_inputs(T=12, hw=3, D=6):
    L = banded.block_cholesky(_band(T, hw, D), jitter=3e-4)
    b = torch.tensor(np.random.default_rng(1).normal(size=(T, D)), dtype=torch.float32)
    return L, b


def test_band_cholesky_solve_on_cpu_is_block_cholesky_solve():
    L, b = _solve_inputs()
    before = band_chol.band_cholesky_solve.launches
    x = band_chol.band_cholesky_solve(L, b)
    assert band_chol.band_cholesky_solve.launches == before      # no kernel on the CPU
    assert torch.equal(x, banded.block_cholesky_solve(L, b))
    # L Lᵀ x = b: the two sweeps through the factor's blocks, f64.
    Ld = L.double()
    y = torch.zeros_like(b, dtype=torch.float64)
    for t in range(12):
        for m in range(4):
            if t - m >= 0:
                y[t - m] += Ld[t, m].mT @ x[t].double()
    Lx = torch.zeros_like(y)
    for t in range(12):
        for m in range(4):
            if t - m >= 0:
                Lx[t] += Ld[t, m] @ y[t - m]
    assert (Lx - b.double()).abs().max() <= 1e-4 * b.abs().max()


@pytest.mark.parametrize("case", ["f64_factor", "f64_rhs", "factor_rank", "not_square",
                                  "rhs_length", "rhs_width", "strided_factor", "strided_rhs",
                                  "two_devices", "meta_device"])
def test_band_cholesky_solve_checks_its_input(case):
    L, b = _solve_inputs()
    meta = torch.device("meta")
    bad = {"f64_factor": (L.double(), b), "f64_rhs": (L, b.double()),
           "factor_rank": (L[0], b), "not_square": (L[..., :5].contiguous(), b[:, :5]),
           "rhs_length": (L, b[:-1]), "rhs_width": (L, b[:, :5]),
           "strided_factor": (L[::2], b[::2].contiguous()),
           "strided_rhs": (L, torch.cat([b, b], 1)[:, ::2]),
           "two_devices": (L, b.to(meta)), "meta_device": (L.to(meta), b.to(meta))}[case]
    err = TypeError if case.startswith("f64") else ValueError
    with pytest.raises(err):
        band_chol.band_cholesky_solve(*bad)
