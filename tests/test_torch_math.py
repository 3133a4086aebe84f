"""Port parity: quaternions, SO(3), the window manifold and the small solves.

The same numpy inputs go through ``glio_tpu`` (JAX, CPU, x64) and
``glio_tpu_torch``. Tolerance 1e-12: both sides run the same f64 formulas,
and only the order of a few sums differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glio_tpu.solver import linalg as jlinalg
from glio_tpu.solver import manifold as jman
from glio_tpu.utils import quat as jquat
from glio_tpu.utils import so3 as jso3
from glio_tpu_torch.solver import linalg as tlinalg
from glio_tpu_torch.solver import manifold as tman
from glio_tpu_torch.utils import quat as tquat
from glio_tpu_torch.utils import so3 as tso3

TOL = 1e-12


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[0, 0] = -abs(q[0, 0])          # one quaternion in the w < 0 hemisphere
    return q


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["normalize", "conj", "positive_hemisphere",
                                  "to_rotmat", "log"])
def test_unary_quat_ops(name):
    q = _quats(np.random.default_rng(0), 64) * 1.3
    if name == "log":
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        q[1] = [1.0, 1e-9, -2e-9, 0.0]   # the small-angle branch
    _close(getattr(tquat, name)(torch.tensor(q)), getattr(jquat, name)(jnp.asarray(q)))


@pytest.mark.parametrize("name", ["exp", "delta_q"])
def test_rotation_vector_ops(name):
    th = np.random.default_rng(1).normal(size=(64, 3))
    th[0] = 0.0
    th[1] = [1e-9, 0.0, -1e-9]
    _close(getattr(tquat, name)(torch.tensor(th)), getattr(jquat, name)(jnp.asarray(th)))


@pytest.mark.parametrize("name", ["mul", "rotate"])
def test_binary_quat_ops(name):
    rng = np.random.default_rng(2)
    a = _quats(rng, 64)
    b = _quats(rng, 64) if name == "mul" else rng.normal(size=(64, 3)) * 50
    _close(getattr(tquat, name)(torch.tensor(a), torch.tensor(b)),
           getattr(jquat, name)(jnp.asarray(a), jnp.asarray(b)))


def test_hat():
    v = np.random.default_rng(3).normal(size=(10, 3))
    _close(tso3.hat(torch.tensor(v)), jso3.hat(jnp.asarray(v)))


def _states(rng, k=5):
    fields = dict(p=rng.normal(size=(k, 3)) * 30, q=_quats(rng, k),
                  v=rng.normal(size=(k, 3)), ba=rng.normal(size=(k, 3)) * 0.1,
                  bg=rng.normal(size=(k, 3)) * 0.01)
    fields["q"][0, 0] = abs(fields["q"][0, 0])
    return (tman.WindowState(**{f: torch.tensor(a) for f, a in fields.items()}),
            jman.WindowState(**{f: jnp.asarray(a) for f, a in fields.items()}))


def test_retract_and_local_coordinates():
    rng = np.random.default_rng(4)
    ts, js = _states(rng)
    tref, jref = _states(rng)
    delta = rng.normal(size=75) * 0.1
    for a, b in zip(tman.retract(ts, torch.tensor(delta)),
                    jman.retract(js, jnp.asarray(delta))):
        _close(a, b)
    _close(tman.local_coordinates(ts, tref), jman.local_coordinates(js, jref))


def test_jacfwd_of_retract_at_zero():
    """The double-where guards keep forward-mode derivatives finite at 0."""
    ts, js = _states(np.random.default_rng(5))

    def flat_t(d):
        return torch.cat([a.reshape(-1) for a in tman.retract(ts, d)])

    def flat_j(d):
        return jnp.concatenate([a.reshape(-1) for a in jman.retract(js, d)])

    Jt = torch.func.jacfwd(flat_t)(torch.zeros(75, dtype=torch.float64))
    Jj = jax.jacfwd(flat_j)(jnp.zeros(75))
    assert torch.isfinite(Jt).all()
    _close(Jt, Jj)


def test_solve_3x3():
    rng = np.random.default_rng(6)
    A = rng.normal(size=(50, 3, 3))
    A = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3)
    b = rng.normal(size=(50, 3))
    _close(tlinalg.solve_3x3(torch.tensor(A), torch.tensor(b), eps=1e-9),
           jlinalg.solve_3x3(jnp.asarray(A), jnp.asarray(b), eps=1e-9), tol=1e-10)


def test_spd_solve():
    rng = np.random.default_rng(7)
    J = rng.normal(size=(120, 75))
    H = J.T @ J + 1e-3 * np.eye(75)
    b = rng.normal(size=75)
    _close(tlinalg.spd_solve(torch.tensor(H), torch.tensor(b)),
           jlinalg.spd_solve(jnp.asarray(H), jnp.asarray(b)), tol=1e-10)


def test_spd_solve_not_pd_gives_nan():
    """JAX's Cholesky returns NaN on a non-PD matrix; the port must too."""
    H = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)
    x = tlinalg.spd_solve(H, torch.ones(2, dtype=torch.float64))
    assert torch.isnan(x).all()
    assert np.isnan(np.asarray(jlinalg.spd_solve(jnp.asarray(H.numpy()), jnp.ones(2)))).all()
