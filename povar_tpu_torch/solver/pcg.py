"""Power-series solve of the reduced camera system (the counterpart of
`power_series` in povar_tpu/solver/pcg.py).

A Python loop takes the place of the `lax.while_loop`. The early exit on
the q/r tolerances needs the stop flag on the host: one device->host
synchronisation per term, and none at all when both tolerances are
disabled (eta <= 0 and r_tolerance <= 0, the benchmark setting).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def _norm(a: torch.Tensor) -> torch.Tensor:
    a = a.reshape(-1)
    return torch.sqrt(torch.dot(a, a))


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
