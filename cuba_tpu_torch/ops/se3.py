"""SE(3) exponential map and left-composed pose updates (port of
``cuba_tpu/ops/se3.py``), including the theta < 1e-5 small-angle branch and
the increment layout ``delta = [omega (rotation), upsilon (translation)]``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cuba_tpu_torch.ops import quaternion as quat

SMALL_ANGLE = 1e-5


def skew(v: torch.Tensor) -> torch.Tensor:
    """(...,3) -> (...,3,3) cross-product matrix [v]x."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def skew_sq(v: torch.Tensor) -> torch.Tensor:
    """[v]x^2 in closed form."""
    x, y, z = v.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, zx = x * y, y * z, z * x
    return torch.stack([
        torch.stack([-yy - zz, xy, zx], dim=-1),
        torch.stack([xy, -zz - xx, yz], dim=-1),
        torch.stack([zx, yz, -xx - yy], dim=-1),
    ], dim=-2)


def exp(delta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """SE(3) exp-map: (...,6) -> (q (...,4), t (...,3)).

    R = I + a1 [w]x + a2 [w]x^2,  V = I + a2 [w]x + a3 [w]x^2,  t = V upsilon
    with (a1, a2, a3) = (sin/th, (1-cos)/th^2, (th-sin)/th^3) and the series
    limits (1, 1/2, 1/6) for th < 1e-5.
    """
    omega = delta[..., :3]
    upsilon = delta[..., 3:6]
    theta = torch.linalg.vector_norm(omega, dim=-1)
    small = theta < SMALL_ANGLE
    th = torch.where(small, torch.ones_like(theta), theta)
    s, c = torch.sin(th), torch.cos(th)
    a1 = torch.where(small, torch.ones_like(th), s / th)
    a2 = torch.where(small, torch.full_like(th, 0.5), (1 - c) / (th * th))
    a3 = torch.where(small, torch.full_like(th, 1.0 / 6.0), (th - s) / (th * th * th))

    O1 = skew(omega)
    O2 = skew_sq(omega)
    eye = torch.eye(3, dtype=delta.dtype, device=delta.device)
    R = eye + a1[..., None, None] * O1 + a2[..., None, None] * O2
    V = eye + a2[..., None, None] * O1 + a3[..., None, None] * O2
    q = quat.from_rotation_matrix(R)
    t = (V * upsilon[..., None, :]).sum(-1)
    return q, t


def update_pose(delta: torch.Tensor, q: torch.Tensor, t: torch.Tensor):
    """Left-compose exp(delta) onto pose (q, t): T_new = exp(delta) * T_old.

    t' = t_exp + R_exp t;  q' = normalize(q_exp * q) with w>=0.
    """
    eq, et = exp(delta)
    t_new = et + quat.rotate(eq, t)
    q_new = quat.normalize(quat.multiply(eq, q))
    return q_new, t_new
