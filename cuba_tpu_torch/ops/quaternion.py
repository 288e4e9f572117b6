"""Quaternion math, layout ``(..., 4) = (x, y, z, w)`` (port of
``cuba_tpu/ops/quaternion.py``).  All functions broadcast over leading dims.
"""

from __future__ import annotations

import torch


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``v`` (...,3) by unit quaternions ``q`` (...,4):
    t = 2 (q_v x v); v' = v + w t + q_v x t."""
    qv = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * torch.linalg.cross(qv, v)
    return v + w * t + torch.linalg.cross(qv, t)


def to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (...,4) -> rotation matrix (...,3,3)."""
    x, y, z, w = q.unbind(-1)
    tx, ty, tz = 2 * x, 2 * y, 2 * z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz, tzz = ty * y, tz * y, tz * z
    return torch.stack([
        torch.stack([1 - (tyy + tzz), txy - twz, txz + twy], dim=-1),
        torch.stack([txy + twz, 1 - (txx + tzz), tyz - twx], dim=-1),
        torch.stack([txz - twy, tyz + twx, 1 - (txx + tyy)], dim=-1),
    ], dim=-2)


def multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, both (...,4) in (x,y,z,w) layout."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by + ay * bw + az * bx - ax * bz,
            aw * bz + az * bw + ax * by - ay * bx,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def normalize(q: torch.Tensor) -> torch.Tensor:
    """Normalize with the w>=0 sign convention."""
    invn = 1.0 / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    invn = torch.where(q[..., 3:4] < 0, -invn, invn)
    return q * invn


def from_rotation_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (...,3,3) -> quaternion (...,4), Shepperd's method,
    branch-free: all four candidate extractions are evaluated with guarded
    square roots and the reference's case rule picks one."""

    def r(i, j):
        return R[..., i, j]

    trace = r(0, 0) + r(1, 1) + r(2, 2)

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-30))

    tw = safe_sqrt(trace + 1)
    sw = 0.5 / tw
    qw_case = torch.stack(
        [(r(2, 1) - r(1, 2)) * sw, (r(0, 2) - r(2, 0)) * sw, (r(1, 0) - r(0, 1)) * sw, 0.5 * tw],
        dim=-1,
    )

    def axis_case(i):
        j, k = (i + 1) % 3, (i + 2) % 3
        t = safe_sqrt(r(i, i) - r(j, j) - r(k, k) + 1)
        s = 0.5 / t
        comp = [None, None, None, None]
        comp[i] = 0.5 * t
        comp[3] = (r(k, j) - r(j, k)) * s
        comp[j] = (r(j, i) + r(i, j)) * s
        comp[k] = (r(k, i) + r(i, k)) * s
        return torch.stack(comp, dim=-1)

    q0, q1, q2 = axis_case(0), axis_case(1), axis_case(2)
    # index rule: i=0; if R11>R00 i=1; if R22>R(i,i) i=2
    use1 = r(1, 1) > r(0, 0)
    qi = torch.where(use1[..., None], q1, q0)
    rii = torch.where(use1, r(1, 1), r(0, 0))
    qi = torch.where((r(2, 2) > rii)[..., None], q2, qi)
    return torch.where((trace > 0)[..., None], qw_case, qi)
