"""The AoS Schur complement: reduce the (6P + 3L) system to 6P, form it
densely, and back-substitute (port of ``cuba_tpu/solver/schur.py``).

Segment sums run through :func:`assembly.segment_sum` (the CSR kernel, in a
fixed order); the dense placement writes every block once (uniquely indexed
``index_put_``, no accumulation), so it is deterministic too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cuba_tpu_torch import trace
from cuba_tpu_torch.ops import segmm, smallmat
from cuba_tpu_torch.ops.segmm import SegmentCSR
from cuba_tpu_torch.solver import comm
from cuba_tpu_torch.solver.assembly import segment_sum


class SchurConsts(NamedTuple):
    hpl_row: torch.Tensor  # [n_hpl] int64
    hpl_col: torch.Tensor  # [n_hpl]
    hsc_row: torch.Tensor  # [n_hsc] (row <= col)
    hsc_col: torch.Tensor  # [n_hsc]
    mul_i: torch.Tensor  # [n_mul] Hpl slot
    mul_j: torch.Tensor  # [n_mul] Hpl slot of the same landmark
    mul_k: torch.Tensor  # [n_mul] Hsc block
    csr_row: SegmentCSR  # hpl_row over [0, num_p)
    csr_col: SegmentCSR  # hpl_col over [0, num_l)
    csr_mul: SegmentCSR  # mul_k over [0, n_hsc)


def schur_consts(s, device) -> SchurConsts:
    """Upload a structure's Schur tables and build their CSRs."""
    def ids(a):
        with trace.span("engine.upload"):
            return torch.as_tensor(a, dtype=torch.int64, device=device)

    return SchurConsts(
        ids(s.hpl_row), ids(s.hpl_col), ids(s.hsc_row), ids(s.hsc_col),
        ids(s.mul_i), ids(s.mul_j), ids(s.mul_k),
        segmm.segment_csr(s.hpl_row, s.num_p, device),
        segmm.segment_csr(s.hpl_col, s.num_l, device),
        segmm.segment_csr(s.mul_k, s.n_hsc, device),
    )


def prepare_factors(bp, Hll_d, bl, Hpl, sc: SchurConsts, num_p: int, group=None):
    """(invHll [L,3,3], W = Hpl invHll [n_hpl,6,3], bsc = bp - W bl [P,6]).
    ``group``: the landmark shards' process group, over which the W bl pose
    sum is all-reduced (``bp`` must already be the global one)."""
    invHll = smallmat.sym3x3_inv(Hll_d)
    W = torch.einsum("kij,kjl->kil", Hpl, invHll[sc.hpl_col])
    Wbl = torch.einsum("kij,kj->ki", W, bl[sc.hpl_col])
    return invHll, W, bp - comm.all_reduce_sum(segment_sum(Wbl, sc.hpl_row, num_p, sc.csr_row),
                                               group)


def triplet_products(W, Hpl, sc: SchurConsts) -> torch.Tensor:
    """W[mul_i] Hpl[mul_j]^T per triplet in the 2-D row layout [36, T]: row
    a*6+b is sum_k W[a, k] Hpl[b, k], three terms in order."""
    T = sc.mul_i.shape[0]
    Wg = W.reshape(-1, 18).T[:, sc.mul_i].view(6, 3, T)  # rows (a*3+k)
    Gg = Hpl.reshape(-1, 18).T[:, sc.mul_j].view(6, 3, T)
    prod = Wg[:, None, 0] * Gg[None, :, 0]
    prod += Wg[:, None, 1] * Gg[None, :, 1]
    prod += Wg[:, None, 2] * Gg[None, :, 2]
    return prod.view(36, T)


def schur_blocks(W, Hpl, sc: SchurConsts) -> torch.Tensor:
    """The sparse block table [n_hsc, 6, 6]: the sum of W[i] Hpl[j]^T over
    each Hsc block's triplets (:func:`triplet_products`), by the CSR kernel;
    triplets with ``mul_k`` out of range drop out."""
    n_hsc = sc.hsc_row.shape[0]
    return segmm.segsum(triplet_products(W, Hpl, sc), sc.mul_k, n_hsc,
                        sc.csr_mul).T.reshape(n_hsc, 6, 6)


def assemble_dense(Hpp_d, W, Hpl, sc: SchurConsts, num_p: int, pad_blocks: int):
    """The dense padded Schur matrix [6PB, 6PB], identity on the padding
    diagonal: Hsc = Hpp_d - sum over triplets of W[i] Hpl[j]^T at block (r,
    c) and its mirror."""
    return dense_from_blocks(Hpp_d, schur_blocks(W, Hpl, sc), sc, num_p, pad_blocks)


def dense_from_blocks(Hpp_d, blocks, sc: SchurConsts, num_p: int, pad_blocks: int):
    """:func:`assemble_dense` from the block table ``blocks`` [n_hsc, 6, 6]."""
    dt, dev = Hpp_d.dtype, Hpp_d.device
    PB = pad_blocks
    D = torch.zeros((PB, 6, PB, 6), dtype=dt, device=dev)
    diag = torch.arange(num_p, device=dev)
    D[diag, :, diag, :] = Hpp_d
    # every block is written once: the uppers (the diagonal ones on top of
    # Hpp_d), then the mirrors below the diagonal
    r, c = sc.hsc_row, sc.hsc_col
    D[r, :, c, :] = D[r, :, c, :] - blocks
    off = r != c
    D[c[off], :, r[off], :] = -blocks[off].transpose(1, 2)
    Dm = D.view(6 * PB, 6 * PB)
    Dm.diagonal()[6 * num_p:] += 1.0
    return Dm


def back_substitute(invHll, bl, Hpl, xp, sc: SchurConsts, num_l: int):
    """xl = Hll^-1 (bl - Hpl^T xp), per landmark [L, 3]."""
    contrib = torch.einsum("kij,ki->kj", Hpl, xp[sc.hpl_row])
    cl = bl - segment_sum(contrib, sc.hpl_col, num_l, sc.csr_col)
    return torch.einsum("kij,kj->ki", invHll, cl)
