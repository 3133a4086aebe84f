"""Dense manifold Levenberg–Marquardt, Gauss-Newton and dogleg (port of ``glio_tpu/solver/dense.py``).

The window is one flat tangent vector (5 keyframes × 15 dof); Jacobians come
from ``torch.func.jacfwd`` through the retraction, the damped normal
equations are solved by an f64 Cholesky, and accept/reject is a masked
select on the device. The iteration count is fixed, so the solve never
waits on the host. ``lm_solve_batched`` runs many independent problems at
once (the JAX package's ``vmap`` of ``lm_solve``: the dense frames' segments).
``gn_solve`` and ``dogleg_solve`` are the JAX package's other two solvers,
off the pipeline's paths there as here.
"""

from typing import Callable, NamedTuple

import torch

from . import linalg
from .manifold import first_leaf, tree_where
from .. import precision as P


# Damping schedule of the JAX package's lm_solve defaults.
LAMBDA_INIT, LAMBDA_UP, LAMBDA_DOWN = 1e-4, 4.0, 0.5
LAMBDA_MIN, LAMBDA_MAX = 1e-10, 1e8
HUBER_DELTA = 1.0       # the reference's HuberLoss(1.0), Estimator.cpp:2092


class LMResult(NamedTuple):
    x: object                  # solution state
    cost: torch.Tensor         # final 0.5‖r‖²
    initial_cost: torch.Tensor
    lam: torch.Tensor
    iters: torch.Tensor        # accepted iterations


def _cost(r):
    return 0.5 * torch.sum(r * r)


def huber_weight(r, delta: float = HUBER_DELTA):
    """IRLS square-root Huber weights (Ceres ``HuberLoss(delta)``); the
    window's lidar rows use the reference's 1.0, loop closure's ICP 0.2.

    Detached, so that differentiation treats the weight as constant at the
    linearization point, as ``stop_gradient`` does in the JAX package.
    """
    a = torch.abs(r)
    w = torch.sqrt(torch.clamp(delta / torch.clamp(a, min=1e-12), max=1.0))
    return w.detach()


def lm_solve(residual_fn: Callable, retract_fn: Callable, x0, tangent_dim: int,
             max_iters: int = 15) -> LMResult:
    """Levenberg–Marquardt with Marquardt diagonal scaling on a manifold.

    residual_fn maps a state to a fixed-shape f64 residual vector (invalid
    rows masked to zero inside); retract_fn applies a tangent step. The
    state is a named tuple of tensors, or of such tuples.
    """
    dev = first_leaf(x0).device
    zeros = torch.zeros(tangent_dim, dtype=P.F64, device=dev)
    r = residual_fn(x0)
    cost = init_cost = _cost(r)
    x = x0
    lam = torch.tensor(LAMBDA_INIT, dtype=P.F64, device=dev)
    accepted = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(max_iters):
        x_lin = x
        J = torch.func.jacfwd(lambda d: residual_fn(retract_fn(x_lin, d)))(zeros)
        H = J.T @ J
        g = J.T @ r
        dH = torch.diagonal(H)
        D = torch.diag(torch.where(dH > 1e-10, dH, torch.ones_like(dH)))
        delta = -linalg.spd_solve(H + lam * D, g)
        x_new = retract_fn(x, delta)
        r_new = residual_fn(x_new)
        new_cost = _cost(r_new)
        improved = new_cost < cost
        x = tree_where(improved, x_new, x)
        r = torch.where(improved, r_new, r)
        cost = torch.where(improved, new_cost, cost)
        lam = torch.clamp(torch.where(improved, lam * LAMBDA_DOWN, lam * LAMBDA_UP),
                          LAMBDA_MIN, LAMBDA_MAX)
        accepted = accepted + improved.to(torch.int32)
    return LMResult(x, cost, init_cost, lam, accepted)
