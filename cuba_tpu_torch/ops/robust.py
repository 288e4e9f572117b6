"""Robust kernels (None / Huber / Tukey) on the squared, information-weighted
residual x = omega * |e|^2 (port of ``cuba_tpu/ops/robust.py``):

  Huber:  rho(x)  = x <= d^2 ? x : 2 d sqrt(x) - d^2
          rho'(x) = x <= d^2 ? 1 : d / sqrt(x)
  Tukey:  rho(x)  = x <= d^2 ? (d^2/3)(1 - (1 - x/d^2)^3) : d^2/3
          rho'(x) = x <= d^2 ? (1 - x/d^2)^2 : 0
"""

from __future__ import annotations

import torch

NONE = 0
HUBER = 1
TUKEY = 2


def robustify(x: torch.Tensor, kernel_type: int, delta: float) -> torch.Tensor:
    """rho(x)."""
    if kernel_type == NONE:
        return x
    d2 = delta * delta
    if kernel_type == HUBER:
        # guard the sqrt argument so the unselected branch stays finite
        safe = torch.clamp(x, min=d2)
        return torch.where(x <= d2, x, 2.0 * torch.sqrt(safe) * delta - d2)
    if kernel_type == TUKEY:
        maxv = d2 / 3.0
        return torch.where(x <= d2, maxv * (1.0 - (1.0 - x / d2) ** 3),
                           torch.full_like(x, maxv))
    raise ValueError(f"unknown robust kernel type {kernel_type}")


def weight(x: torch.Tensor, kernel_type: int, delta: float) -> torch.Tensor:
    """rho'(x), the IRLS weight applied to omega."""
    if kernel_type == NONE:
        return torch.ones_like(x)
    d2 = delta * delta
    if kernel_type == HUBER:
        safe = torch.clamp(x, min=d2)
        return torch.where(x <= d2, torch.ones_like(x), delta / torch.sqrt(safe))
    if kernel_type == TUKEY:
        return torch.where(x <= d2, (1.0 - x / d2) ** 2, torch.zeros_like(x))
    raise ValueError(f"unknown robust kernel type {kernel_type}")
