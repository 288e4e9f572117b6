"""Optimizer configuration (port of ``cuba_tpu/config.py``).

The LM hyper-parameters keep ``cuba_tpu``'s defaults.  Dtypes are torch
dtypes, and ``device`` names where every tensor of the engine lives: the
card by default; the host only when asked for (``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Configuration for :class:`cuba_tpu_torch.BundleAdjustment`.

    Attributes:
      dtype: compute dtype of the numeric path, float32 or float64, on the
        card as on the host.  On the card float64 runs the fp64 builds of
        the ten ``segmm`` kernels, and its dense solve is
        ``cholesky_ex`` + ``solve_triangular`` (the ``trisolve`` kernels
        are float32 only, as ``cuba_tpu``'s are).
      chi_dtype: accumulation dtype of the chi² reductions.
      device: where the engine's tensors live: "cuda" (the default),
        "cuda:1", ..., or "cpu", where every kernel runs its plain torch
        version.  Without a CUDA device the default fails at
        ``initialize()``; it never carries on on the host.
      max_inner_iterations: LM trust-region retries per outer iteration.
      tau: initial damping factor, lambda0 = tau * max(diag H).
      scale_eps: epsilon added to the gain-ratio denominator.
      attenuation_min/max: clamp bounds of the accepted-step damping
        attenuation 1-(2*rho-1)^3.
      solver: reduced-system solver.  "pcg" (block-Jacobi preconditioned
        conjugate gradient on the matrix-free Schur operator), "band_cr"
        (block-tridiagonal cyclic reduction on a band-certified Schur
        pattern), "dense_cholesky" (equilibrated Cholesky of the dense
        Schur complement, with iterative refinement) or "auto", which picks
        as cuba_tpu does: band_cr for a pure band of at least 8 CR blocks,
        band_lr for a band with loop columns, dense_cholesky up to 4096
        padded pose blocks, else pcg.  "band_lr" is cyclic reduction on
        the in-band part with a Woodbury correction over at most 64
        loop-closure pose columns.
      numerical_escalation: lambda factor when the solve fails (PCG did not
        converge, or the factor or the step was non-finite).
      pcg_max_iterations / pcg_tol: PCG stopping controls.
      refinement_steps: iterative-refinement sweeps after the fp32 band or
        dense solve (none in fp64; the dense solve on the card adds one).
      pose_block_pad: pad the reduced system to a multiple of this many
        pose blocks (a positive multiple of 128).
      phase_attribution: populate the reference's 8-phase TimeProfile from
        normal ``optimize()`` runs.  The loop marks each phase's boundaries
        as it goes (CUDA events on the card's current stream, with no
        extra synchronisation; the host clock on the CPU); the first
        ``time_profile()`` after a run reads them and scales the five loop
        phases to that run's measured wall.  Exact per-phase host timing
        is still available via ``optimize(n, profile=True)``.
      mesh: run the optimizer over several processes, landmark-sharded
        (``parallel/sharding.py``).  ``None`` (the default) runs on one
        device.  Otherwise a ``torch.distributed`` process group, or a 1-D
        ``DeviceMesh`` whose ``mesh_dim_names`` are ``("landmarks",)``;
        its size is the shard count.  Every rank of the group builds the
        same graph and makes the same calls; ``device`` is where this
        rank's tensors live.  Poses are replicated, the landmarks and
        their edges split into contiguous blocks, and the reduced system
        is summed over the group and solved on every rank.
    """

    dtype: torch.dtype = torch.float32
    chi_dtype: torch.dtype = torch.float64
    device: Union[str, torch.device] = "cuda"
    max_inner_iterations: int = 10
    tau: float = 1e-5
    scale_eps: float = 1e-3
    attenuation_min: float = 1.0 / 3.0
    attenuation_max: float = 2.0 / 3.0
    solver: str = "auto"
    numerical_escalation: float = 8.0
    pcg_max_iterations: int = 250
    pcg_tol: float = 1e-10
    refinement_steps: int = 1
    pose_block_pad: int = 128
    phase_attribution: bool = True
    mesh: Optional[object] = None  # a ProcessGroup, or a DeviceMesh with a "landmarks" dim

    def resolve_device(self) -> torch.device:
        return torch.device(self.device)
