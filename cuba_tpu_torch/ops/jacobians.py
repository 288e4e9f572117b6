"""Analytic Jacobians of the reprojection residual, edge-batched (port of
``cuba_tpu/ops/jacobians.py``).  The pose block JP is (mdim x 6), rotation
in columns 0..2 and translation in 3..5; the landmark block JL is
(mdim x 3).  Signs are folded so that solving H d = b with b = J^T Omega e,
e = proj - meas, and applying exp(d) on the left descends the objective.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cuba_tpu_torch.ops import quaternion as quat


def mono(Xc: torch.Tensor, q: torch.Tensor,
         cam: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (JP (...,2,6), JL (...,2,3))."""
    X, Y, Z = Xc.unbind(-1)
    inv_z = 1.0 / Z
    x, y = inv_z * X, inv_z * Y
    fu, fv = cam[..., 0], cam[..., 1]
    fu_iz, fv_iz = fu * inv_z, fv * inv_z
    R = quat.to_rotation_matrix(q)
    jl0 = torch.stack([-fu_iz * (R[..., 0, k] - x * R[..., 2, k]) for k in range(3)], dim=-1)
    jl1 = torch.stack([-fv_iz * (R[..., 1, k] - y * R[..., 2, k]) for k in range(3)], dim=-1)
    zero = torch.zeros_like(fu)
    jp0 = torch.stack([fu * x * y, -fu * (1 + x * x), fu * y, -fu_iz, zero, fu_iz * x], dim=-1)
    jp1 = torch.stack([fv * (1 + y * y), -fv * x * y, -fv * x, zero, -fv_iz, fv_iz * y], dim=-1)
    return torch.stack([jp0, jp1], dim=-2), torch.stack([jl0, jl1], dim=-2)


def stereo(Xc: torch.Tensor, q: torch.Tensor,
           cam: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (JP (...,3,6), JL (...,3,3))."""
    X, Y, Z = Xc.unbind(-1)
    inv_z = 1.0 / Z
    inv_zz = inv_z * inv_z
    fu, fv, bf = cam[..., 0], cam[..., 1], cam[..., 4]
    R = quat.to_rotation_matrix(q)
    jl0 = torch.stack([-fu * R[..., 0, k] * inv_z + fu * X * R[..., 2, k] * inv_zz
                       for k in range(3)], dim=-1)
    jl1 = torch.stack([-fv * R[..., 1, k] * inv_z + fv * Y * R[..., 2, k] * inv_zz
                       for k in range(3)], dim=-1)
    jl2 = jl0 - bf[..., None] * R[..., 2, :] * inv_zz[..., None]
    zero = torch.zeros_like(fu)
    jp0 = torch.stack([X * Y * inv_zz * fu, -(1 + X * X * inv_zz) * fu, Y * inv_z * fu,
                       -inv_z * fu, zero, X * inv_zz * fu], dim=-1)
    jp1 = torch.stack([(1 + Y * Y * inv_zz) * fv, -X * Y * inv_zz * fv, -X * inv_z * fv,
                       zero, -inv_z * fv, Y * inv_zz * fv], dim=-1)
    jp2 = torch.stack([jp0[..., 0] - bf * Y * inv_zz, jp0[..., 1] + bf * X * inv_zz,
                       jp0[..., 2], jp0[..., 3], zero, jp0[..., 5] - bf * inv_zz], dim=-1)
    return torch.stack([jp0, jp1, jp2], dim=-2), torch.stack([jl0, jl1, jl2], dim=-2)


def compute(Xc, q, cam, mdim: int):
    if mdim == 2:
        return mono(Xc, q, cam)
    if mdim == 3:
        return stereo(Xc, q, cam)
    raise ValueError(f"measurement dim must be 2 or 3, got {mdim}")
