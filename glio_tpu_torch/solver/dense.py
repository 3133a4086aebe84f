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
    zeros = torch.zeros(tangent_dim, dtype=torch.float64, device=dev)
    r = residual_fn(x0)
    cost = init_cost = _cost(r)
    x = x0
    lam = torch.tensor(LAMBDA_INIT, dtype=torch.float64, device=dev)
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


def lm_solve_batched(residual_fn: Callable, retract_fn: Callable, x0, tangent_dim: int,
                     max_iters: int = 15) -> LMResult:
    """``lm_solve`` over B independent problems at once, each with its own
    damping and accept/reject: the JAX package's ``vmap`` of ``lm_solve``.

    The state's fields carry a leading axis B; residual_fn maps it to
    (B, R) rows, and retract_fn applies (B, tangent_dim) steps. Problem b's
    rows must depend on its own state only: one forward-mode pass over a
    tangent added to every problem then gives all B Jacobians (B, R, n).
    Returns an LMResult whose cost, lam and iters have shape (B,).
    """
    B = x0[0].shape[0]
    dev = x0[0].device
    zeros = torch.zeros(tangent_dim, dtype=torch.float64, device=dev)
    r = residual_fn(x0)
    cost = init_cost = 0.5 * torch.sum(r * r, dim=-1)
    x = x0
    lam = torch.full((B,), LAMBDA_INIT, dtype=torch.float64, device=dev)
    accepted = torch.zeros((B,), dtype=torch.int32, device=dev)
    for _ in range(max_iters):
        x_lin = x
        J = torch.func.jacfwd(
            lambda d: residual_fn(retract_fn(x_lin, d.expand(B, tangent_dim))))(zeros)
        H = J.mT @ J
        g = torch.einsum("brn,br->bn", J, r)
        dH = torch.diagonal(H, dim1=-2, dim2=-1)
        D = torch.diag_embed(torch.where(dH > 1e-10, dH, torch.ones_like(dH)))
        delta = -linalg.spd_solve(H + lam[:, None, None] * D, g)
        x_new = retract_fn(x, delta)
        r_new = residual_fn(x_new)
        new_cost = 0.5 * torch.sum(r_new * r_new, dim=-1)
        improved = new_cost < cost
        x = type(x)(*(torch.where(improved.view(-1, *([1] * (a.dim() - 1))), a_new, a)
                      for a, a_new in zip(x, x_new)))
        r = torch.where(improved[:, None], r_new, r)
        cost = torch.where(improved, new_cost, cost)
        lam = torch.clamp(torch.where(improved, lam * LAMBDA_DOWN, lam * LAMBDA_UP),
                          LAMBDA_MIN, LAMBDA_MAX)
        accepted = accepted + improved.to(torch.int32)
    return LMResult(x, cost, init_cost, lam, accepted)


def gn_solve(residual_fn: Callable, retract_fn: Callable, x0, tangent_dim: int,
             max_iters: int = 8, damping: float = 1e-9) -> LMResult:
    """Plain Gauss-Newton: every step accepted, ``damping`` on the diagonal.
    ``initial_cost`` is the cost at x0, ``iters`` the step count."""
    dev = first_leaf(x0).device
    zeros = torch.zeros(tangent_dim, dtype=torch.float64, device=dev)
    eye = torch.eye(tangent_dim, dtype=torch.float64, device=dev)
    x = x0
    init_cost = None
    for _ in range(max_iters):
        r = residual_fn(x)
        if init_cost is None:
            init_cost = _cost(r)
        x_lin = x
        J = torch.func.jacfwd(lambda d: residual_fn(retract_fn(x_lin, d)))(zeros)
        H = J.T @ J + damping * eye
        x = retract_fn(x, -linalg.spd_solve(H, J.T @ r))
    if init_cost is None:
        init_cost = _cost(residual_fn(x0))
    return LMResult(x, _cost(residual_fn(x)), init_cost,
                    torch.zeros((), dtype=torch.float64, device=dev),
                    torch.tensor(max_iters, dtype=torch.int32, device=dev))


def dogleg_solve(residual_fn: Callable, retract_fn: Callable, x0, tangent_dim: int,
                 max_iters: int = 15, trust_init: float = 1.0,
                 trust_max: float = 1e4) -> LMResult:
    """Powell's dogleg with trust-region radius adaptation (the reference's
    ``ceres::DOGLEG``, Estimator.cpp:2428): between the Cauchy point and the
    Gauss-Newton point inside the trust region, the radius doubled above a
    gain ratio of 0.75 and quartered below 0.25. ``lam`` of the result is
    the final radius."""
    dev = first_leaf(x0).device
    f64 = dict(dtype=torch.float64, device=dev)
    zeros = torch.zeros(tangent_dim, **f64)
    eye = torch.eye(tangent_dim, **f64)
    cost = init_cost = _cost(residual_fn(x0))
    x = x0
    radius = torch.tensor(trust_init, **f64)
    accepted = torch.zeros((), dtype=torch.int32, device=dev)
    one = torch.ones((), **f64)
    for _ in range(max_iters):
        r = residual_fn(x)
        x_lin = x
        J = torch.func.jacfwd(lambda d: residual_fn(retract_fn(x_lin, d)))(zeros)
        g = J.T @ r
        H = J.T @ J
        h_gn = -linalg.spd_solve(H + 1e-12 * eye, g)      # Gauss-Newton point
        gBg = g @ (H @ g)
        alpha = torch.where(gBg > 0, (g @ g) / torch.clamp(gBg, min=1e-30), one)
        h_sd = -alpha * g                                   # Cauchy point
        n_gn = torch.linalg.norm(h_gn)
        n_sd = torch.linalg.norm(h_sd)
        d = h_gn - h_sd
        dd = d @ d
        sd_d = h_sd @ d
        disc = torch.clamp(sd_d ** 2 + dd * (radius ** 2 - n_sd ** 2), min=0.0)
        beta = torch.where(dd > 0, (-sd_d + torch.sqrt(disc)) / torch.clamp(dd, min=1e-30),
                           torch.zeros_like(dd))
        h_interp = h_sd + torch.clamp(beta, 0.0, 1.0) * d
        h = torch.where(n_gn <= radius, h_gn,
                        torch.where(n_sd >= radius,
                                    h_sd * (radius / torch.clamp(n_sd, min=1e-30)), h_interp))
        x_new = retract_fn(x, h)
        new_cost = _cost(residual_fn(x_new))
        pred_red = -(g @ h) - 0.5 * h @ (H @ h)
        rho = (cost - new_cost) / torch.clamp(pred_red, min=1e-30)
        improved = (new_cost < cost) & (pred_red > 0)
        x = tree_where(improved, x_new, x)
        cost = torch.where(improved, new_cost, cost)
        radius = torch.where(rho > 0.75, torch.clamp(radius * 2.0, max=trust_max),
                             torch.where(rho < 0.25, radius * 0.25, radius))
        radius = torch.clamp(radius, min=1e-10)
        accepted = accepted + improved.to(torch.int32)
    return LMResult(x, cost, init_cost, radius, accepted)
