"""The AoS system assembly: per-edge residuals, chi² and the block
quadratic form over edge-batched (array-of-structs) tensors (port of
``cuba_tpu/solver/assembly.py``).

This is the path the engine takes where the rows planner finds no plan:
pose-only and landmark-only problems, structures without Hpl slots, and a
``schur_fused`` chunk plan that does not hold.  Gathers are tensor
indexing; every segment sum is :func:`segment_sum`, ``segmm.segsum`` (the
CSR segment-sum kernel on the card) with the summation order fixed once
per structure, so a run gives the same bits every time (no atomics).
Contributions of fixed vertices carry ids past the active range and are
dropped, as ``cuba_tpu``'s clamp row drops them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from cuba_tpu_torch import trace
from cuba_tpu_torch.ops import jacobians, projection, robust, segmm
from cuba_tpu_torch.ops.segmm import SegmentCSR


class EdgeConsts(NamedTuple):
    """Per-edge device tensors of one measurement dimension."""

    meas: torch.Tensor  # [E, mdim]
    omega: torch.Tensor  # [E]
    pose_idx: torch.Tensor  # [E] int64, < total_p
    lm_idx: torch.Tensor  # [E] int64, < total_l
    edge2hpl: torch.Tensor  # [E] int64, n_hpl for "no slot"
    csr_pose: SegmentCSR  # pose_idx over [0, num_p)
    csr_lm: SegmentCSR  # lm_idx over [0, num_l)
    csr_hpl: SegmentCSR  # edge2hpl over [0, n_hpl)


def edge_consts(meas, omega, pose_idx, lm_idx, edge2hpl, num_p, num_l, n_hpl, device,
                dtype) -> EdgeConsts:
    """Upload one edge type's arrays and build its three CSRs."""
    def up(a, dt=torch.int64):
        with trace.span("engine.upload"):
            return torch.as_tensor(a, dtype=dt, device=device)

    return EdgeConsts(
        up(meas, dtype), up(omega, dtype), up(pose_idx), up(lm_idx), up(edge2hpl),
        segmm.segment_csr(pose_idx, num_p, device),
        segmm.segment_csr(lm_idx, num_l, device),
        segmm.segment_csr(edge2hpl, n_hpl, device),
    )


def segment_sum(data: torch.Tensor, ids: torch.Tensor, num: int,
                csr: SegmentCSR) -> torch.Tensor:
    """Rows of ``data`` [N, ...] summed by ``ids`` [N] into [num, ...]; ids
    outside [0, num) are dropped.  On the card: the CSR segment-sum kernel
    over the [D, N] transpose, in the CSR's fixed order."""
    tail = data.shape[1:]
    vals = data.reshape(data.shape[0], math.prod(tail)).T.contiguous()
    return segmm.segsum(vals, ids, num, csr).T.reshape((num,) + tail)


def edge_residuals(qs, ts, cams, Xws, ec: EdgeConsts, mdim: int):
    """Per-edge residual e = proj - meas [E, mdim] and camera-frame point
    Xc [E, 3]."""
    Xc = projection.world_to_camera(qs[ec.pose_idx], ts[ec.pose_idx], Xws[ec.lm_idx])
    return projection.project(Xc, cams[ec.pose_idx], mdim) - ec.meas, Xc


def chi_squares(err: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """Per-edge unrobustified chi² [E]."""
    return omega * (err * err).sum(-1)


def chi_sum(err, omega, kernel, chi_dtype) -> torch.Tensor:
    """sum_e rho(omega |e|^2), accumulated in ``chi_dtype``."""
    return robust.robustify(chi_squares(err, omega), kernel[0], kernel[1]).to(chi_dtype).sum()


def quadratic_form_terms(qs, cams, err, Xc, ec: EdgeConsts, mdim: int, kernel):
    """Per-edge weighted Gauss-Newton blocks: (Hpp_e [E,6,6], bp_e [E,6],
    Hll_e [E,3,3], bl_e [E,3], Hpl_e [E,6,3])."""
    w = ec.omega * robust.weight(chi_squares(err, ec.omega), kernel[0], kernel[1])
    JP, JL = jacobians.compute(Xc, qs[ec.pose_idx], cams[ec.pose_idx], mdim)
    wJP = w[:, None, None] * JP
    wJL = w[:, None, None] * JL
    return (torch.einsum("eki,ekj->eij", wJP, JP), torch.einsum("eki,ek->ei", wJP, err),
            torch.einsum("eki,ekj->eij", wJL, JL), torch.einsum("eki,ek->ei", wJL, err),
            torch.einsum("eki,ekj->eij", wJP, JL))


def build_system(qs, cams, num_p: int, num_l: int, n_hpl: int, edges, kernels):
    """Hpp [P,6,6], bp [P,6], Hll [L,3,3], bl [L,3], Hpl [n_hpl,6,3] from
    ``edges``: per edge type (EdgeConsts, err, Xc, mdim), or None for an
    absent type.  One segment sum per vertex kind and edge type (Hpp with
    bp, Hll with bl, Hpl)."""
    dt, dev = qs.dtype, qs.device
    Hpp = torch.zeros((num_p, 6, 6), dtype=dt, device=dev)
    bp = torch.zeros((num_p, 6), dtype=dt, device=dev)
    Hll = torch.zeros((num_l, 3, 3), dtype=dt, device=dev)
    bl = torch.zeros((num_l, 3), dtype=dt, device=dev)
    Hpl = torch.zeros((n_hpl, 6, 3), dtype=dt, device=dev)
    for item, kern in zip(edges, kernels):
        if item is None:
            continue
        ec, err, Xc, mdim = item
        Hpp_e, bp_e, Hll_e, bl_e, Hpl_e = quadratic_form_terms(qs, cams, err, Xc, ec, mdim,
                                                               kern)
        E = err.shape[0]
        if num_p:
            p42 = segment_sum(torch.cat([Hpp_e.reshape(E, 36), bp_e], 1), ec.pose_idx,
                              num_p, ec.csr_pose)
            Hpp = Hpp + p42[:, :36].reshape(num_p, 6, 6)
            bp = bp + p42[:, 36:]
        if num_l:
            l12 = segment_sum(torch.cat([Hll_e.reshape(E, 9), bl_e], 1), ec.lm_idx, num_l,
                              ec.csr_lm)
            Hll = Hll + l12[:, :9].reshape(num_l, 3, 3)
            bl = bl + l12[:, 9:]
        if n_hpl:
            Hpl = Hpl + segment_sum(Hpl_e, ec.edge2hpl, n_hpl, ec.csr_hpl)
    return Hpp, bp, Hll, bl, Hpl


def max_diagonal(Hpp: torch.Tensor, Hll: torch.Tensor) -> torch.Tensor:
    """Max over the active block-diagonal entries, floored at 0."""
    parts = [torch.diagonal(H, dim1=-2, dim2=-1).max() for H in (Hpp, Hll) if H.shape[0]]
    if not parts:
        return torch.zeros((), dtype=Hpp.dtype, device=Hpp.device)
    m = parts[0] if len(parts) == 1 else torch.maximum(parts[0], parts[1])
    return torch.clamp(m, min=0.0)


def damp(H: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """H + lambda I on each diagonal block."""
    return H + lam * torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
