"""Fixed-size symmetric solves, batched over leading dims (port of
``cuba_tpu/ops/smallmat.py``): the closed-form 3x3 inverse, the 3x3 solve,
and the 6x6 solve through an inner 3x3 Schur complement.
"""

from __future__ import annotations

import torch


def sym3x3_inv(A: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of symmetric (...,3,3) matrices, reading the
    upper triangle and A(2,0), A(1,2); the result is exactly symmetric."""
    a00, a01, a11 = A[..., 0, 0], A[..., 0, 1], A[..., 1, 1]
    a02, a12, a22 = A[..., 2, 0], A[..., 1, 2], A[..., 2, 2]
    det = (a00 * a11 * a22 + a01 * a12 * a02 + a02 * a01 * a12
           - a00 * a12 * a12 - a02 * a11 * a02 - a01 * a01 * a22)
    inv_det = 1.0 / det
    b00 = inv_det * (a11 * a22 - a12 * a12)
    b01 = inv_det * (a02 * a12 - a01 * a22)
    b11 = inv_det * (a00 * a22 - a02 * a02)
    b02 = inv_det * (a01 * a12 - a02 * a11)
    b12 = inv_det * (a02 * a01 - a00 * a12)
    b22 = inv_det * (a00 * a11 - a01 * a01)
    return torch.stack([torch.stack([b00, b01, b02], dim=-1),
                        torch.stack([b01, b11, b12], dim=-1),
                        torch.stack([b02, b12, b22], dim=-1)], dim=-2)


def solve_sym3x3(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = H^-1 b for symmetric (...,3,3), b (...,3)."""
    return torch.einsum("...ij,...j->...i", sym3x3_inv(H), b)


def solve_sym6x6(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = H^-1 b for symmetric (...,6,6): with H = [[A, B], [B^T, D]],
    x_p = (A - B D^-1 B^T)^-1 (b_p - B D^-1 b_l), x_l = D^-1 (b_l - B^T x_p)."""
    A, Bm, D = H[..., :3, :3], H[..., :3, 3:], H[..., 3:, 3:]
    bp, bl = b[..., :3], b[..., 3:]
    invD = sym3x3_inv(D)
    B_invD = torch.einsum("...ij,...jk->...ik", Bm, invD)
    Hsc = A - torch.einsum("...ik,...jk->...ij", B_invD, Bm)
    bsc = bp - torch.einsum("...ij,...j->...i", B_invD, bl)
    xp = solve_sym3x3(Hsc, bsc)
    cl = bl - torch.einsum("...ji,...j->...i", Bm, xp)
    return torch.cat([xp, torch.einsum("...ij,...j->...i", invD, cl)], dim=-1)
