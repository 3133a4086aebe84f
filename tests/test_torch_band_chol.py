"""The f32 block-banded Cholesky factor's and solve's kernel wrappers
(``ops/band_chol.py``) on the CPU: their route to the plain versions, their
input checks and the block sizes and half-widths the kernels are built for. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from glio_tpu_torch.ops import band_chol
from glio_tpu_torch.solver import banded
from glio_tpu_torch.testing import spd_band
from glio_tpu_torch.utils import profiling


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
    before = profiling.tallies().get("band_cholesky.launches", 0)
    L = band_chol.band_cholesky(band, 3e-4)
    # No kernel on the CPU.
    assert profiling.tallies().get("band_cholesky.launches", 0) == before
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
    before = profiling.tallies().get("band_cholesky_solve.launches", 0)
    x = band_chol.band_cholesky_solve(L, b)
    # No kernel on the CPU.
    assert profiling.tallies().get("band_cholesky_solve.launches", 0) == before
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


def test_kernel_table_is_the_shared_memory_bound():
    """The kernels are built for D = 6, 7 and 15, each up to the largest hw
    whose shared memory fits the 227 KB a block may opt into: both kernels
    fit at D = 15, hw = 8 (231,688 and 205,168 bytes), the factor does not at
    hw = 9 (266,100)."""
    assert band_chol.KERNEL_D == {6: 15, 7: 15, 15: 8}
    assert band_chol._smem(15, 8) == (231688, 205168)
    assert band_chol._smem(15, 9)[0] > band_chol.SMEM_MAX >= band_chol._smem(15, 8)[0]


@pytest.mark.parametrize("D, hw", [(5, 3), (8, 3), (16, 1), (6, 16), (7, 16), (15, 9)])
def test_kernel_shape_refusals(D, hw):
    """A block size the kernels are not built for, or an hw past that size's
    shared memory, is refused with a message that names what is built."""
    with pytest.raises(ValueError, match="D in \\[6, 7, 15\\]" if D not in (6, 7, 15)
                       else f"hw <= {band_chol.KERNEL_D[D]}"):
        band_chol._check_kernel_shape("band_cholesky", D, hw)


@pytest.mark.parametrize("D, hw", [(7, 7), (15, 7), (15, 8), (8, 3)])
def test_band_kernels_on_cpu_are_plain_at_any_block_size(D, hw):
    """On the CPU both wrappers run their plain versions at any block size
    (D = 8 included: only the card's kernels are limited to the built ones)."""
    band = spd_band(40, hw, D, seed=D)
    L = band_chol.band_cholesky(band, 3e-4)
    assert torch.equal(L, banded.block_cholesky(band, jitter=3e-4))
    assert bool(torch.isfinite(L).all())
    b = torch.tensor(np.random.default_rng(D).normal(size=(40, D)), dtype=torch.float32)
    x = band_chol.band_cholesky_solve(L, b)
    assert torch.equal(x, banded.block_cholesky_solve(L, b))
    x64 = banded.block_cholesky_solve(L.double(), b.double())
    assert (x.double() - x64).abs().max() <= 1e-4 * x64.abs().max()


def test_builds_of_other_block_sizes_are_their_own_libraries():
    """Every block size builds one library per hw, under a name and hash of
    its own; the build of every kernel makes those of the batch paths (hw
    7), and ``band_chol.cu`` is built only so."""
    from glio_tpu_torch.ops import _build
    defines = {D: {hw: (f"BAND_CHOL_D={D}", f"BAND_CHOL_HW={hw}") for hw in (3, 7)}
               for D in (6, 7, 15)}
    paths = {_build.library_path("band_chol.cu", d) for by_hw in defines.values()
             for d in by_hw.values()}
    assert len(paths) == 6
    for D in (6, 7, 15):
        name = _build.library_path("band_chol.cu", defines[D][7]).name
        assert name.startswith(f"libband_chol_{D}_7_")
    assert {d for _, d in _build.VARIANTS} == {defines[D][7] for D in (6, 7, 15)}
    assert "band_chol.cu" not in _build.SOURCES
