"""Optimizer configuration (port of ``cuba_tpu/config.py``).

The LM hyper-parameters keep ``cuba_tpu``'s defaults.  Dtypes are torch
dtypes, and ``device`` names where every tensor of the engine lives.  Only
the matrix-free PCG reduced solver is ported so far; the engine rejects any
other ``solver`` (ROADMAP queue 1, "Band solver" and "Dense solver").
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Configuration for :class:`cuba_tpu_torch.BundleAdjustment`.

    Attributes:
      dtype: compute dtype of the numeric path (float32 or float64; the CUDA
        kernels are float32 only).
      chi_dtype: accumulation dtype of the chi² reductions.
      device: where the engine's tensors live ("cuda", "cuda:0", ...);
        ``None`` keeps them on the CPU, where every kernel runs its plain
        torch version.
      max_inner_iterations: LM trust-region retries per outer iteration.
      tau: initial damping factor, lambda0 = tau * max(diag H).
      scale_eps: epsilon added to the gain-ratio denominator.
      attenuation_min/max: clamp bounds of the accepted-step damping
        attenuation 1-(2*rho-1)^3.
      solver: reduced-system solver.  Only "pcg" (block-Jacobi
        preconditioned conjugate gradient on the matrix-free Schur operator)
        is ported; the default "auto" and every other value raise
        NotImplementedError at ``initialize()``.
      numerical_escalation: lambda factor when the solve fails (PCG did not
        converge or gave a non-finite step).
      pcg_max_iterations / pcg_tol: PCG stopping controls.
    """

    dtype: torch.dtype = torch.float32
    chi_dtype: torch.dtype = torch.float64
    device: Optional[Union[str, torch.device]] = None
    max_inner_iterations: int = 10
    tau: float = 1e-5
    scale_eps: float = 1e-3
    attenuation_min: float = 1.0 / 3.0
    attenuation_max: float = 2.0 / 3.0
    solver: str = "auto"
    numerical_escalation: float = 8.0
    pcg_max_iterations: int = 250
    pcg_tol: float = 1e-10

    def resolve_device(self) -> torch.device:
        return torch.device(self.device) if self.device is not None else torch.device("cpu")
