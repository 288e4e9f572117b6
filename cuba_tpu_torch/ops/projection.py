"""Camera projection: world -> camera -> image, mono (pinhole) and stereo
(pinhole + disparity), over edge-batched (..., 3) tensors (port of
``cuba_tpu/ops/projection.py``).  The camera is the pose vertex's 5-vector
(fx, fy, cx, cy, bf); the stereo third coordinate is u_right = u - bf/Z.
"""

from __future__ import annotations

import torch

from cuba_tpu_torch.ops import quaternion as quat


def world_to_camera(q: torch.Tensor, t: torch.Tensor, Xw: torch.Tensor) -> torch.Tensor:
    """Xc = R(q) Xw + t."""
    return quat.rotate(q, Xw) + t


def project_mono(Xc: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """(...,3) camera point, (...,5) camera -> (...,2) pixel."""
    inv_z = 1.0 / Xc[..., 2]
    u = cam[..., 0] * inv_z * Xc[..., 0] + cam[..., 2]
    v = cam[..., 1] * inv_z * Xc[..., 1] + cam[..., 3]
    return torch.stack([u, v], dim=-1)


def project_stereo(Xc: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """(...,3) camera point, (...,5) camera -> (...,3) (u_l, v, u_r)."""
    inv_z = 1.0 / Xc[..., 2]
    u = cam[..., 0] * inv_z * Xc[..., 0] + cam[..., 2]
    v = cam[..., 1] * inv_z * Xc[..., 1] + cam[..., 3]
    return torch.stack([u, v, u - cam[..., 4] * inv_z], dim=-1)


def project(Xc: torch.Tensor, cam: torch.Tensor, mdim: int) -> torch.Tensor:
    if mdim == 2:
        return project_mono(Xc, cam)
    if mdim == 3:
        return project_stereo(Xc, cam)
    raise ValueError(f"measurement dim must be 2 or 3, got {mdim}")
