"""Transposed ("rows") per-edge front end: residuals, chi and Gauss-Newton
terms over ``[D, E]`` tensors, E on the last axis (port of
``cuba_tpu/solver/edgerows.py``).

Padding lanes carry gathered zeros, which would give inf/NaN through the
1/Z projection; ``inv_z`` is therefore masked by validity, and the padded
omega (0) kills what remains in the weighted terms.
"""

from __future__ import annotations

import torch

from cuba_tpu_torch.ops import robust


def rotmat_rows(q4: torch.Tensor) -> torch.Tensor:
    """Unit quaternion rows [4, E] (x, y, z, w) -> rotation entries [3, 3, E]."""
    x, y, z, w = q4.unbind(0)
    tx, ty, tz = 2 * x, 2 * y, 2 * z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz, tzz = ty * y, tz * y, tz * z
    return torch.stack([
        torch.stack([1 - (tyy + tzz), txy - twz, txz + twy]),
        torch.stack([txy + twz, 1 - (txx + tzz), tyz - twx]),
        torch.stack([txz - twy, tyz + twx, 1 - (txx + tyy)]),
    ])


def residual_rows(g12: torch.Tensor, xw: torch.Tensor, measT: torch.Tensor,
                  valid: torch.Tensor, mdim: int):
    """err [mdim, E], Xc [3, E], R [3, 3, E], inv_z [E].

    g12 [12, E]: gathered pose rows q(4), t(3), cam(5); xw [3, E]: gathered
    landmark rows; measT [mdim, E]; valid [E] (False on padding lanes).
    """
    R = rotmat_rows(g12[0:4])
    Xc = (R * xw[None, :, :]).sum(1) + g12[4:7]
    X, Y, Z = Xc.unbind(0)
    cam = g12[7:12]
    one = torch.ones((), dtype=Z.dtype, device=Z.device)
    zero = torch.zeros((), dtype=Z.dtype, device=Z.device)
    inv_z = torch.where(valid, 1.0 / torch.where(valid, Z, one), zero)
    u = cam[0] * inv_z * X + cam[2]
    v = cam[1] * inv_z * Y + cam[3]
    if mdim == 2:
        err = torch.stack([u - measT[0], v - measT[1]])
    else:
        ur = u - cam[4] * inv_z
        err = torch.stack([u - measT[0], v - measT[1], ur - measT[2]])
    err = torch.where(valid[None, :], err, zero)
    return err, Xc, R, inv_z


def chi_per_edge(err: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """Per-edge unrobustified chi² [E]."""
    return omega * (err * err).sum(0)


def chi_rows(err: torch.Tensor, omega: torch.Tensor, kernel, chi_dtype) -> torch.Tensor:
    """sum_e rho(omega |e|^2), accumulated in ``chi_dtype``; padding omega is 0."""
    rho = robust.robustify(chi_per_edge(err, omega), kernel[0], kernel[1])
    return rho.to(chi_dtype).sum()


def jac_rows(Xc: torch.Tensor, R: torch.Tensor, inv_z: torch.Tensor,
             cam: torch.Tensor, mdim: int):
    """Projection Jacobians JP [mdim, 6, E] (pose) and JL [mdim, 3, E]
    (landmark); cam [5, E] is (fu, fv, cu, cv, bf)."""
    X, Y, Z = Xc.unbind(0)
    fu, fv, bf = cam[0], cam[1], cam[4]
    zero = torch.zeros_like(fu)
    if mdim == 2:
        x = inv_z * X
        y = inv_z * Y
        fu_iz = fu * inv_z
        fv_iz = fv * inv_z
        JL = torch.stack([-fu_iz * (R[0] - x * R[2]), -fv_iz * (R[1] - y * R[2])])
        JP = torch.stack([
            torch.stack([fu * x * y, -fu * (1 + x * x), fu * y, -fu_iz, zero, fu_iz * x]),
            torch.stack([fv * (1 + y * y), -fv * x * y, -fv * x, zero, -fv_iz, fv_iz * y]),
        ])
        return JP, JL
    inv_zz = inv_z * inv_z
    jl0 = -fu * R[0] * inv_z + fu * X * R[2] * inv_zz
    jl1 = -fv * R[1] * inv_z + fv * Y * R[2] * inv_zz
    jl2 = jl0 - bf * R[2] * inv_zz
    jp0 = [X * Y * inv_zz * fu, -(1 + X * X * inv_zz) * fu, Y * inv_z * fu,
           -inv_z * fu, zero, X * inv_zz * fu]
    jp1 = [(1 + Y * Y * inv_zz) * fv, -X * Y * inv_zz * fv, -X * inv_z * fv,
           zero, -inv_z * fv, Y * inv_zz * fv]
    jp2 = [jp0[0] - bf * Y * inv_zz, jp0[1] + bf * X * inv_zz, jp0[2],
           jp0[3], zero, jp0[5] - bf * inv_zz]
    JP = torch.stack([torch.stack(jp0), torch.stack(jp1), torch.stack(jp2)])
    return JP, torch.stack([jl0, jl1, jl2])


def term_rows(err, Xc, R, inv_z, cam, omega, kernel, mdim: int):
    """Weighted GN term rows: (v42 [42, E], v12 [12, E], v18 [18, E]).

    Row order is the planner's table layout: Hpp row-major (i*6+j) then bp,
    Hll (a*3+b) then bl, Hpl (i*3+b).  Padding lanes have omega == 0.
    """
    E = err.shape[1]
    w = omega * robust.weight(chi_per_edge(err, omega), kernel[0], kernel[1])
    JP, JL = jac_rows(Xc, R, inv_z, cam, mdim)
    wJP = w * JP
    wJL = w * JL
    v42 = torch.cat([torch.einsum("kie,kje->ije", wJP, JP).reshape(36, E),
                     torch.einsum("kie,ke->ie", wJP, err)])
    v12 = torch.cat([torch.einsum("kae,kbe->abe", wJL, JL).reshape(9, E),
                     torch.einsum("kae,ke->ae", wJL, err)])
    v18 = torch.einsum("kie,kbe->ibe", wJP, JL).reshape(18, E).contiguous()
    return v42, v12, v18
