"""Port parity: LM on the window manifold, Schur marginalization, Huber IRLS.

Held against the JAX package's exact-f64 settings: ``lm_solve`` with no f32
residual twin and ``mixed_chol=False``, ``marginalize(mixed_chol=False)``.
Tolerances: 1e-9 (f64 solves of well-conditioned systems; the
eigendecompositions and Cholesky factors come from different LAPACK
call sequences); the LM solution to 1e-9 after 25 iterations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glio_tpu.solver import dense as jdense
from glio_tpu.solver import manifold as jman
from glio_tpu.solver import marginalization as jmarg
from glio_tpu.utils import quat as jquat
from glio_tpu_torch.solver import dense as tdense
from glio_tpu_torch.solver import manifold as tman
from glio_tpu_torch.solver import marginalization as tmarg
from glio_tpu_torch.utils import quat as tquat

K = 4


def _pose_graph(rng):
    """Noisy relative-pose chain over K keyframes, a pose prior on frame 0
    and a conflicting position fix on the last frame (so the optimum has a
    nonzero cost); velocity and biases held by weak priors."""
    p = np.cumsum(rng.normal(size=(K, 3)), axis=0)
    q = rng.normal(size=(K, 4)) * 0.2
    q[:, 0] = 1.0
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    rel_p = (p[1:] - p[:-1]) + rng.normal(size=(K - 1, 3)) * 0.05
    p = p.copy()
    p[-1] += 0.2                                   # the conflicting fix
    init = dict(p=p + rng.normal(size=p.shape) * 0.3,
                q=q + rng.normal(size=q.shape) * 0.05,
                v=np.zeros((K, 3)), ba=np.zeros((K, 3)), bg=np.zeros((K, 3)))
    init["q"] /= np.linalg.norm(init["q"], axis=-1, keepdims=True)
    return p, q, rel_p, init


def _residual(qmod, cat, p, q, rel_p):
    def res(s):
        return cat([
            (s.p[1:] - s.p[:-1] - rel_p).reshape(-1),
            (s.p[0] - p[0]) * 10.0,
            s.p[-1] - p[-1],
            qmod.log(qmod.mul(qmod.conj(q), s.q)).reshape(-1),
            0.1 * s.v.reshape(-1), 0.1 * s.ba.reshape(-1), 0.1 * s.bg.reshape(-1)])
    return res


def test_lm_solve_matches_jax():
    p, q, rel_p, init = _pose_graph(np.random.default_rng(0))
    t = lambda a: torch.tensor(a)
    res_t = _residual(tquat, torch.cat, t(p), t(q), t(rel_p))
    res_j = _residual(jquat, jnp.concatenate, jnp.asarray(p), jnp.asarray(q),
                      jnp.asarray(rel_p))
    out_t = tdense.lm_solve(res_t, tman.retract,
                            tman.WindowState(**{k: t(v) for k, v in init.items()}),
                            K * 15, max_iters=25)
    out_j = jdense.lm_solve(res_j, jman.retract,
                            jman.WindowState(**{k: jnp.asarray(v) for k, v in init.items()}),
                            K * 15, max_iters=25, mixed_chol=False)
    for a, b in zip(out_t.x, out_j.x):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(out_t.cost.item(), float(out_j.cost), rtol=1e-9)
    assert out_t.iters.item() == int(out_j.iters)
    assert out_t.cost.item() < 0.1 * out_t.initial_cost.item()


@pytest.mark.parametrize("case", ["full_rank", "rank_deficient_drop_block"])
def test_marginalize_matches_jax(case):
    rng = np.random.default_rng(1)
    J = rng.normal(size=(150, 75))
    if case == "rank_deficient_drop_block":
        # Two drop-block directions no factor sees: the eigen clip must
        # treat them as zero on both sides.
        J[:, 3:5] = 0.0
    H, b = J.T @ J, J.T @ rng.normal(size=150)
    pt = tmarg.marginalize(torch.tensor(H), torch.tensor(b), 15)
    pj = jmarg.marginalize(jnp.asarray(H), jnp.asarray(b), 15, mixed_chol=False)
    np.testing.assert_allclose(pt.sqrt_jac.numpy(), np.asarray(pj.sqrt_jac),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(pt.sqrt_res.numpy(), np.asarray(pj.sqrt_res),
                               rtol=1e-9, atol=1e-9)


def test_marginalize_falls_back_when_cholesky_fails():
    """An indefinite Schur complement: the port takes the eigen fallback on
    the device, with the JAX main path's semantics (finite, clipped)."""
    H = np.eye(6) * 4.0
    H[3:, 3:] = np.diag([1.0, -2.0, 3.0])      # indefinite kept block
    b = np.arange(6.0)
    pt = tmarg.marginalize(torch.tensor(H), torch.tensor(b), 3)
    pj = jmarg.marginalize(jnp.asarray(H), jnp.asarray(b), 3)   # mixed path
    assert torch.isfinite(pt.sqrt_jac).all() and torch.isfinite(pt.sqrt_res).all()
    np.testing.assert_allclose(pt.sqrt_jac.T.numpy() @ pt.sqrt_jac.numpy(),
                               np.asarray(pj.sqrt_jac).T @ np.asarray(pj.sqrt_jac),
                               atol=1e-9)


def test_huber_weight_is_constant_under_jacfwd():
    """``.detach()`` must act as ``stop_gradient`` under ``torch.func``."""
    rng = np.random.default_rng(2)
    A = rng.normal(size=(40, 6)) * 2.0
    x0 = rng.normal(size=6)

    def f_t(x):
        r = torch.tensor(A) @ x
        return r * tdense.huber_weight(r)

    def f_j(x):
        r = jnp.asarray(A) @ x
        return r * jdense.huber_weight(r, 1.0)

    Jt = torch.func.jacfwd(f_t)(torch.tensor(x0))
    Jj = jax.jacfwd(f_j)(jnp.asarray(x0))
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), rtol=1e-12, atol=1e-12)
    w = np.asarray(jdense.huber_weight(jnp.asarray(A @ x0), 1.0))
    assert (w < 1.0).any()                     # some rows are down-weighted
    np.testing.assert_allclose(Jt.numpy(), w[:, None] * A, rtol=1e-12)
