"""Dense reduced solve: Jacobi-equilibrated Cholesky with iterative
refinement (port of ``cuba_tpu/solver/dense_cholesky.py``).

The numerical contract is ``cuba_tpu``'s: the system is equilibrated
(A' = S A S, S = diag(A)^-1/2), an fp32 factorisation that fails is
retried with a diagonal boost (delta = 1e-5, x32 per try, at most 4 tries),
refinement sweeps recompute the residual against the original A and keep
the last finite iterate, and a non-finite result reports ok=False with x
zeroed (a rejected LM step).

The factorisation is ``torch.linalg.cholesky_ex`` (``cuba_tpu`` leaves it to
XLA too).  ``cholesky_ex`` reports a failure in ``info`` and returns a
finite, partly factored L, where JAX's ``cholesky`` returns NaN: the retry
reads ``info`` (one host read per retry decision, where ``cuba_tpu`` loops
on the device), and a factor that still fails is overwritten with NaN, so
the solve and ``ok`` see it.  The triangular solves are the blocked sweeps
of ``solver/trisolve.py`` (hand-written CUDA on the card) with
``use_kernels``, else ``torch.linalg.solve_triangular`` and ``A @ v``, as
``cuba_tpu`` runs them off the TPU.
"""

from __future__ import annotations

import torch

from cuba_tpu_torch import trace
from cuba_tpu_torch.solver import trisolve

_BOOST0, _BOOST_GROWTH, _BOOST_TRIES = 1e-5, 32.0, 4


def _failed(L: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """Whether a factorisation failed: ``info`` set, or a non-finite last
    row (NaN or inf in A passes through ``cholesky_ex``)."""
    return (info != 0) | ~torch.isfinite(L[-1].sum())


def _cholesky(As: torch.Tensor):
    """(L, info), L lower and row-major.  torch returns factors in
    column-major storage; the upper factor's is L in row-major order, which
    the stripe kernels read row by row (``contiguous`` copies nothing
    then).  Each call, the first factorisation and every boost retry, is
    one ``dense.cholesky`` span."""
    with trace.span("dense.cholesky"):
        U, info = torch.linalg.cholesky_ex(As, upper=True)
        return U.mT.contiguous(), info


def factor(As: torch.Tensor):
    """Cholesky factor of the equilibrated As, with the fp32 boost retry.
    Returns (L, host_reads); L is all NaN where every try failed."""
    with trace.span("dense.factor"):
        L, info = _cholesky(As)
        reads = 0
        if As.dtype == torch.float32:
            delta = 0.0
            for _ in range(_BOOST_TRIES):
                reads += 1
                with trace.span("read.dense_boost"):
                    failed = bool(_failed(L, info))
                if not failed:
                    return L, reads
                delta = _BOOST0 if delta == 0.0 else delta * _BOOST_GROWTH
                Ab = As.clone()
                Ab.diagonal().add_(delta)
                L, info = _cholesky(Ab)
        nan = torch.full((), float("nan"), dtype=L.dtype, device=L.device)
        return torch.where(_failed(L, info), nan, L), reads


def cholesky_solve(A: torch.Tensor, b: torch.Tensor, refinement_steps: int = 0,
                   use_kernels: bool = False):
    """Solve A x = b for SPD A [n, n].  Returns (x, ok, host_reads); x is 0
    where ok is False.  ``use_kernels`` takes the blocked sweeps of
    :mod:`trisolve` (their kernels on the card; n must pass
    :func:`trisolve.usable` there).  The whole solve is one ``dense`` span,
    the diagonal blocks' inverses one ``dense.prepare``."""
    with trace.span("dense"):
        s = torch.rsqrt(torch.clamp(torch.diagonal(A), min=1e-30))
        L, reads = factor(A * s[:, None] * s[None, :])

        if use_kernels:
            with trace.span("dense.prepare"):
                invd = trisolve.prepare(L)

            def solve_with(rhs):
                with trace.span("dense.solve"):
                    y = trisolve.solve_lower(L, invd, rhs * s)
                    return s * trisolve.solve_upper(L, invd, y)

            def mv(v):
                return trisolve.matvec(A, v)
        else:
            def solve_with(rhs):
                with trace.span("dense.solve"):
                    y = torch.linalg.solve_triangular(L, (rhs * s)[:, None], upper=False)
                    return s * torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]

            def mv(v):
                return A @ v

        x = solve_with(b)
        for _ in range(refinement_steps):
            x2 = x + solve_with(b - mv(x))
            # refinement diverges near the fp32 precision floor while the factor
            # stays finite: keep the last finite iterate
            x = torch.where(torch.isfinite(x2.sum()), x2, x)
        ok = torch.isfinite(x).all()
        return torch.where(ok, x, torch.zeros_like(x)), ok, reads
