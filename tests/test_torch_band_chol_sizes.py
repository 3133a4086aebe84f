"""Port parity of the band kernels' reference at the block sizes 7 and 15:
the plain ``solver/banded.block_cholesky`` and ``block_cholesky_solve`` in
f32 (what ``ops/band_chol.py`` runs on the CPU, and what the card's kernels
are held to) against the JAX package's ``block_cholesky`` and
``block_cholesky_solve`` in f32, on the same numpy inputs: a diagonally
dominant band of 24 block rows at hw = 7 (``testing.spd_band``), sound and
with block row 12's diagonal negated (its Cholesky breaks down; the solve
then takes that row as the identity, as ``f32_chol_precond`` does).

Tolerance: 1e-5 of the largest entry, NaN block rows equal (JAX leaves 0
above the diagonal of a broken block, the port NaN). The two libraries sum
each block product in another order (the port a dot in c order, XLA its
own); measured here 1.7e-7 (factor) and 1.4e-7 (solve) at D = 7, 8.4e-8
and 1.6e-7 at D = 15. D = 6 is held so in ``test_torch_batch_chol_pcg.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glio_tpu.solver import banded as JBand
from glio_tpu_torch.solver import banded as TBand
from glio_tpu_torch.testing import spd_band

T, HW, JITTER, RTOL = 24, 7, 3e-4, 1e-5


def _inputs(D, broken):
    band = spd_band(T, HW, D, seed=D).numpy()
    if broken:
        band[T // 2, HW] = -band[T // 2, HW]
    b = np.random.default_rng(D).normal(size=(T, D)).astype(np.float32)
    return band, b


def _identity_rows(Lb):
    """The factor with each broken (non-finite) block row the identity."""
    Lb = Lb.copy()
    bad = ~np.isfinite(Lb).all(axis=(1, 2, 3))
    Lb[bad] = 0.0
    Lb[bad, 0] = np.eye(Lb.shape[-1], dtype=Lb.dtype)
    return Lb, bad


def _rel(a, ref):
    return np.abs(a - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("D", [7, 15])
@pytest.mark.parametrize("broken", [False, True], ids=["sound", "broken_row"])
def test_block_cholesky_and_solve_f32_match_jax(D, broken):
    band, b = _inputs(D, broken)
    L_t = TBand.block_cholesky(torch.tensor(band), jitter=JITTER).numpy()
    L_j = np.asarray(JBand.block_cholesky(jnp.asarray(band), jitter=JITTER))
    assert L_t.dtype == L_j.dtype == np.float32
    Lg, bad = _identity_rows(L_j)
    assert np.nonzero(bad)[0].tolist() == ([T // 2] if broken else [])
    np.testing.assert_array_equal(~np.isfinite(L_t).all(axis=(1, 2, 3)), bad)
    assert _rel(L_t[~bad], L_j[~bad]) <= RTOL

    x_t = TBand.block_cholesky_solve(torch.tensor(Lg), torch.tensor(b)).numpy()
    x_j = np.asarray(JBand.block_cholesky_solve(jnp.asarray(Lg), jnp.asarray(b)))
    assert x_t.dtype == x_j.dtype == np.float32
    assert np.isfinite(x_t).all()
    assert _rel(x_t, x_j) <= RTOL
