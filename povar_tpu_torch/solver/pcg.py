"""The inner solves of the reduced camera system: the power series and
preconditioned conjugate gradients (the counterparts of `power_series`
and `conjugate_gradients` in povar_tpu/solver/pcg.py).

Python loops take the place of the `lax.while_loop`s. An early exit
needs its stop flag on the host: one device->host synchronisation per
power term (none at all when both tolerances are disabled, eta <= 0 and
r_tolerance <= 0, the benchmark setting) and one per CG iteration.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

# termination codes (ConjugateGradientsSolver::Summary::TerminationType)
NO_CONVERGENCE = 0
SUCCESS = 1
FAILURE = 2


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_dot(a, a))


def conjugate_gradients(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor,
    precond: Callable[[torch.Tensor], torch.Tensor],
    max_iterations: int,
    min_iterations: int = 0,
    q_tolerance: float = 1e-2,
    r_tolerance: float = -1.0,
    residual_reset_period: int = 10,
) -> Tuple[torch.Tensor, int, int]:
    """Solve matvec(x) = b (conjugate_gradient.hpp:114-301). Returns
    (x, num_iterations, termination code), with the JAX loop's iteration
    counts: the q-tolerance (Nash truncated-Newton zeta) test after
    `min_iterations`, the optional r-tolerance, the residual refreshed
    from b - matvec(x) every `residual_reset_period` iterations, and on
    rho or p'q zero, non-positive or NaN a FAILURE that keeps the
    previous iterate. |b| = 0 returns zeros and an initial residual
    within the r-tolerance returns x0, both after 0 iterations."""
    norm_b = _norm(b)
    tol_r = torch.tensor(r_tolerance, dtype=b.dtype, device=b.device) * norm_b
    r = b - matvec(x0)
    zero_b, init_conv = (bool(v) for v in torch.stack([
        norm_b == 0.0, (min_iterations == 0) & (_norm(r) <= tol_r),
    ]).tolist())
    if zero_b:
        return torch.zeros_like(b), 0, SUCCESS
    if init_conv:
        return x0, 0, SUCCESS
    x = x0
    q0 = -_dot(x0, b + r)
    p = torch.zeros_like(b)
    rho = torch.ones((), dtype=b.dtype, device=b.device)
    term = NO_CONVERGENCE
    it = 0
    while it < max_iterations:
        it += 1
        z = precond(r)
        last_rho = rho
        rho = _dot(r, z)
        # NaN included, as in the JAX package: a NaN would otherwise
        # pass every comparison and run to max_iterations
        rho_bad = (rho == 0.0) | ~torch.isfinite(rho)
        p = z if it == 1 else z + (rho / last_rho) * p
        q = matvec(p)
        pq = _dot(p, q)
        pq_bad = (pq <= 0.0) | ~torch.isfinite(pq)
        alpha = rho / pq
        x_new = x + alpha * p
        # periodic residual refresh (conjugate_gradient.hpp:228-240)
        if it % residual_reset_period == 0:
            r_new = b - matvec(x_new)
        else:
            r_new = r - alpha * q
        q1 = -_dot(x_new, b + r_new)
        zeta = it * (q1 - q0) / q1
        converged = (zeta < q_tolerance) | (_norm(r_new) <= tol_r)
        if it < min_iterations:
            converged = torch.zeros_like(converged)
        failed = rho_bad | pq_bad
        # on failure keep the previous iterate (the reference breaks
        # before updating x on rho / p'q failure)
        x = torch.where(failed, x, x_new)
        r = torch.where(failed, r, r_new)
        q0 = q1
        failed, converged = (bool(v) for v in torch.stack([
            failed, converged]).tolist())
        if failed:
            term = FAILURE
            break
        if converged:
            term = SUCCESS
            break
    return x, it, term


def power_series(
    b_inv_apply: Callable[[torch.Tensor], torch.Tensor],
    e0_apply: Callable[[torch.Tensor], torch.Tensor],
    neg_b: torch.Tensor,
    max_terms: int,
    q_tolerance: float,
    r_tolerance: float,
) -> Tuple[torch.Tensor, int]:
    """Power-series expansion of the inverse Schur complement:

        x = sum_{i=0..m} (B^-1 E0)^i B^-1 (-b)

    with the reference's q/r-tolerance early exit
    (sc/linearization_power_varproj.hpp:191-237). Returns (x, num_terms);
    the term counts are those of the JAX loop."""
    accum = b_inv_apply(neg_b)
    check = q_tolerance > 0 or r_tolerance > 0
    norm_0 = _norm(accum) if check else None
    tmp = accum
    i = 0
    while i < max_terms:
        i += 1
        tmp = b_inv_apply(e0_apply(tmp))
        accum = accum + tmp
        if not check:
            continue
        iter_norm = _norm(tmp)
        zeta = i * iter_norm / _norm(accum)
        stop = torch.zeros((), dtype=torch.bool, device=accum.device)
        if q_tolerance > 0:
            stop = stop | (zeta < q_tolerance)
        if r_tolerance > 0:
            stop = stop | (iter_norm / norm_0 < r_tolerance)
        if bool(stop):
            break
    return accum, i
