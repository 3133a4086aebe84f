"""Port parity: the block-banded solver (``solver/banded.py``).

Random block-banded SPD systems (made with numpy from a seed, hw = 3,
D = 6, as dense as the band allows) go through ``glio_tpu.solver.banded``
and ``glio_tpu_torch.solver.banded`` in f64 on the CPU, and the solves are
also held against a dense ``torch.linalg.solve`` / inverse. Tolerances are
relative to the solution's size: 1e-10 (f64 round-off on systems of
condition ~1e4, in another order of operations).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glio_tpu.solver import banded as jb
from glio_tpu_torch.solver import banded as tb

HW, D = 3, 6


def random_band(T, seed=0, hw=HW):
    """A symmetric positive-definite block band, its dense matrix, a RHS."""
    rng = np.random.default_rng(seed)
    n = T * D
    J = np.zeros((2 * n, n))
    for t in range(T):
        for k in range(2):
            cols = slice(t * D, min(T, t + hw + 1) * D)
            rows = slice(2 * t * D + k * D, 2 * t * D + (k + 1) * D)
            J[rows, cols] = rng.normal(size=(D, cols.stop - cols.start))
    H = J.T @ J + 0.5 * np.eye(n)
    band = np.zeros((T, 2 * hw + 1, D, D))
    for t in range(T):
        for o in range(2 * hw + 1):
            c = t + o - hw
            if 0 <= c < T:
                band[t, o] = H[t * D:(t + 1) * D, c * D:(c + 1) * D]
    return band, H, rng.normal(size=(T, D))


def test_random_band_is_banded():
    band, H, _ = random_band(9)
    dense = np.zeros_like(H)
    for t in range(9):
        for o in range(2 * HW + 1):
            c = t + o - HW
            if 0 <= c < 9:
                dense[t * D:(t + 1) * D, c * D:(c + 1) * D] = band[t, o]
    np.testing.assert_array_equal(dense, H)


def test_occurrence_groups():
    idx = np.array([4, 1, 4, 4, 0, 1])
    groups = tb.occurrence_groups(idx)
    assert [g.tolist() for g in groups] == [[0, 1, 4], [2, 5], [3]]
    assert tb.occurrence_groups(np.array([], int)) == []


def test_scatter_add_blocks_with_duplicates_matches_jax():
    """Duplicate targets are summed one at a time in the order of the
    updates, which is what ``.at[].add`` does on the CPU: equal bit for bit."""
    rng = np.random.default_rng(2)
    T, hw = 10, 2
    band0 = rng.normal(size=(T, 2 * hw + 1, D, D)) * 1e3
    rows = rng.integers(0, T, size=200)
    cols = np.clip(rows + rng.integers(-hw, hw + 1, size=200), 0, T - 1)
    blocks = rng.normal(size=(200, D, D)) * 10.0 ** rng.integers(-8, 8, size=(200, 1, 1))
    ref = np.asarray(jb.scatter_add_blocks(jnp.asarray(band0), jnp.asarray(rows),
                                           jnp.asarray(cols), jnp.asarray(blocks), hw))
    got = tb.scatter_add_blocks(torch.tensor(band0), rows, cols, torch.tensor(blocks), hw)
    np.testing.assert_array_equal(got.numpy(), ref)
    plan = tb.block_plan(rows, cols, hw, "cpu")
    assert plan.groups is not None and len(plan.groups) > 1
    again = tb.scatter_add_blocks(torch.tensor(band0), None, None, torch.tensor(blocks),
                                  hw, plan=plan)
    np.testing.assert_array_equal(again.numpy(), ref)


def test_scatter_add_rows_unique_targets():
    x = torch.zeros(5, 2, dtype=torch.float64)
    plan = tb.scatter_plan(np.array([3, 0, 4]), "cpu")
    assert plan.groups is None
    tb.scatter_add_rows(x, torch.ones(3, 2, dtype=torch.float64), plan)
    np.testing.assert_array_equal(x[:, 0].numpy(), [1, 0, 0, 1, 1])


def test_band_matvec_matches_jax_and_dense():
    band, H, b = random_band(11, seed=1)
    got = tb.band_matvec(torch.tensor(band), torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jb.band_matvec(jnp.asarray(band), jnp.asarray(b))),
                               rtol=1e-13, atol=1e-12)
    np.testing.assert_allclose(got.reshape(-1), H @ b.reshape(-1), rtol=1e-12, atol=1e-10)


def _rel_err(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("T", [1, 2, 7, 8, 60])
def test_cyclic_reduction_solve_matches_jax_and_dense(T):
    """T = 1, 2 are the base cases; 7 pads the super-rows (7 = 3·3 − 2) and
    has an odd count; 8 pads to 9 block rows; 60 runs five levels."""
    band, H, b = random_band(T, seed=T)
    got = tb.cyclic_reduction_solve(torch.tensor(band), torch.tensor(b)).numpy()
    ref = np.asarray(jb.cyclic_reduction_solve(jnp.asarray(band), jnp.asarray(b)))
    dense = torch.linalg.solve(torch.tensor(H), torch.tensor(b.reshape(-1))).numpy()
    assert got.shape == (T, D)
    assert _rel_err(got, ref) < 1e-10
    assert _rel_err(got.reshape(-1), dense) < 1e-10


def test_cyclic_reduction_solve_nan_when_not_spd():
    """A failed Cholesky gives NaN (as JAX's does), not an exception."""
    band, _, b = random_band(8, seed=3)
    band[2, HW] = -np.eye(D)
    x = tb.cyclic_reduction_solve(torch.tensor(band), torch.tensor(b))
    assert torch.isnan(x).any()


def test_pcg_solve_matches_jax():
    band, H, b = random_band(20, seed=4)
    x_t, r_t = tb.pcg_solve(torch.tensor(band), torch.tensor(b), iters=150)
    x_j, r_j = jb.pcg_solve(jnp.asarray(band), jnp.asarray(b), iters=150)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0, atol=1e-9)
    dense = np.linalg.solve(H, b.reshape(-1))
    assert _rel_err(x_t.numpy().reshape(-1), dense) < 1e-8
    assert float(r_t) < 1e-8 and float(r_j) < 1e-8


@pytest.mark.parametrize("T", [2, 8, 60])
def test_selected_inverse_diag_matches_dense_inverse(T):
    band, H, _ = random_band(T, seed=10 + T)
    got = tb.selected_inverse_diag(torch.tensor(band)).numpy()
    inv = np.linalg.inv(H)
    dense = np.stack([inv[t * D:(t + 1) * D, t * D:(t + 1) * D] for t in range(T)])
    assert _rel_err(got, dense) < 1e-10
    ref = np.asarray(jb.selected_inverse_diag(jnp.asarray(band)))
    assert _rel_err(got, ref) < 1e-10


def test_band_to_tridiag_matches_jax():
    band, _, _ = random_band(8, seed=5)
    got = tb.band_to_tridiag(torch.tensor(band))
    ref = jb.band_to_tridiag(jnp.asarray(band))
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[3:] == tuple(ref[3:])
