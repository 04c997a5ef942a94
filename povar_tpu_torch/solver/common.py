"""Shared solver-layer pieces: residual accounting.

ResidualInfo mirrors bal/residual_info.hpp:36-104; the parallel-reduce
accumulator of the reference becomes a couple of masked sums.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch


def to_host(*vals) -> list:
    """Python floats for a mix of 0-d tensors (on one device) and
    numbers, with ONE device->host transfer for all the tensors (each
    scalar pulled on its own would be one synchronisation apiece)."""
    out = list(vals)
    idx = [i for i, v in enumerate(vals) if isinstance(v, torch.Tensor)]
    if idx:
        host = torch.stack(
            [vals[i].to(torch.float64).reshape(()) for i in idx]
        ).tolist()
        for i, h in zip(idx, host):
            out[i] = h
    return [float(v) for v in out]


@dataclass
class ResidualItem:
    num_obs: int = 0
    error: float = 0.0
    residual_sum: float = 0.0

    def error_avg(self) -> float:
        return self.error / self.num_obs if self.num_obs > 0 else 0.0

    def residual_mean(self) -> float:
        return self.residual_sum / self.num_obs if self.num_obs > 0 else 0.0


@dataclass
class ResidualInfo:
    all: ResidualItem
    valid: ResidualItem
    is_numerically_valid: bool = True

    @staticmethod
    def from_device(d: Dict[str, torch.Tensor]) -> "ResidualInfo":
        """Host copy of an accumulate_residual_info-style dict, in one
        device->host transfer."""
        return ResidualInfo.from_values(*to_host(*(
            d[k] for k in (
                "num_obs_all", "error_all", "residual_sum_all",
                "num_obs_valid", "error_valid", "residual_sum_valid",
                "is_numerically_valid",
            )
        )))

    @staticmethod
    def from_values(
        num_all, err_all, rsum_all, num_valid, err_valid, rsum_valid,
        numerically_valid,
    ) -> "ResidualInfo":
        return ResidualInfo(
            all=ResidualItem(
                num_obs=int(num_all), error=float(err_all),
                residual_sum=float(rsum_all),
            ),
            valid=ResidualItem(
                num_obs=int(num_valid), error=float(err_valid),
                residual_sum=float(rsum_valid),
            ),
            is_numerically_valid=bool(numerically_valid),
        )


def accumulate_residual_info(
    weighted_error: torch.Tensor,  # [O]
    res_norm: torch.Tensor,  # [O]
    projection_valid: torch.Tensor,  # [O] bool
    numerically_valid: torch.Tensor,  # [O] bool
    num_obs_all=None,  # live-observation count (excl. padding rows)
) -> Dict[str, torch.Tensor]:
    """Device-side ResidualInfoAccu (residual_info.cpp:96-109): `all`
    sums everything; `valid` sums projection-valid observations;
    is_numerically_valid is the AND over observations."""
    validf = projection_valid.to(weighted_error.dtype)
    if num_obs_all is None:
        num_obs_all = weighted_error.shape[0]
    dev = weighted_error.device
    return {
        # a fill, not a host-to-device copy: no synchronisation, and
        # capturable into the device LM loop's CUDA graph
        "num_obs_all": torch.full((), num_obs_all, dtype=torch.int64,
                                  device=dev),
        "error_all": weighted_error.sum(),
        "residual_sum_all": res_norm.sum(),
        "num_obs_valid": projection_valid.to(torch.int64).sum(),
        "error_valid": (weighted_error * validf).sum(),
        "residual_sum_valid": (res_norm * validf).sum(),
        "is_numerically_valid": numerically_valid.all(),
    }


def error_summary_oneline(info: ResidualInfo, valid_first: bool) -> str:
    """residual_info.cpp:78-95."""
    warn = "" if info.is_numerically_valid else "!NaN! "

    def one(item: ResidualItem) -> str:
        return (
            f"{item.error:.4e} (mean res: {item.residual_mean():.2f}, "
            f"num: {item.num_obs})"
        )

    if valid_first:
        return f"{warn}error valid: {one(info.valid)}, error: {one(info.all)}"
    return f"{warn}error: {one(info.all)}, error valid: {one(info.valid)}"
