"""BAL (Bundle Adjustment in the Large) format loader (port of
``cuba_tpu/io/bal.py``, the same conversion).

Parses the public BAL text format (Agarwal et al., "Bundle Adjustment in
the Large", ECCV 2010 — grail.cs.washington.edu/projects/bal):

    <num_cameras> <num_points> <num_observations>
    <camera_i> <point_i> <x> <y>          # one line per observation
    <9 params per camera>                  # R (Rodrigues), t, f, k1, k2
    <3 params per point>                   # Xw

and converts it into a :class:`cuba_tpu_torch.models.graph.BundleAdjustment`
graph (the reference loads its own cv::FileStorage layout instead,
samples/sample_ba_from_file.cpp:91-164 — BAL support is an extension so
real public datasets can drive the same engine).

Model conversion.  BAL cameras look down **-z** and project with
``p = -(Px, Py)/Pz``, then ``obs = f * r(p) * p`` with radial distortion
``r(p) = 1 + k1*|p|^2 + k2*|p|^4``.  The pinhole model (like the
reference's, include/cuda_bundle_adjustment_types.h:51-62) looks down
**+z**: ``u = fx*Px/Pz + cx``.  The loader therefore

1. rotates each camera frame by ``M = Ry(pi) = diag(-1, 1, -1)`` (a proper
   rotation: ``R' = M R``, ``t' = M t``), after which depths are positive
   for points in front of the BAL camera, and
2. maps each observation ``(x, y) -> (-x, y)``, which makes the ideal
   (distortion-free) BAL projection identical to the pinhole prediction,
   and
3. undistorts observations on the host (vectorized Newton on the radial
   polynomial) so the k1/k2 terms are folded into the measurements.  With
   ``k1 = k2 = 0`` the conversion is exact; otherwise it is the standard
   "undistort then pinhole-BA" treatment and ``undistort=False`` raises
   rather than silently mis-modelling.

BAL problems are gauge-free (ceres regularizes instead); ``fix_first_pose``
(default True) pins camera 0, matching how the reference's SLAM graphs pin
their first keyframe.
"""

from __future__ import annotations

import gzip
from typing import Optional

import numpy as np

from cuba_tpu_torch.models.graph import BundleAdjustment
from cuba_tpu_torch.models.types import CameraParams, LandmarkVertex, MonoEdge, PoseVertex

# Ry(pi) as a quaternion in (x, y, z, w) order, and as a matrix.
_FLIP_Q = np.array([0.0, 1.0, 0.0, 0.0])
_FLIP_M = np.diag([-1.0, 1.0, -1.0])


def _rodrigues_to_quat(rvecs: np.ndarray) -> np.ndarray:
    """Axis-angle vectors [n,3] -> unit quaternions [n,4] in (x,y,z,w)."""
    theta = np.linalg.norm(rvecs, axis=1, keepdims=True)
    half = 0.5 * theta
    # sin(t/2)/t -> 1/2 as t -> 0; series keeps fp64 accuracy at tiny angles
    small = theta < 1e-8
    with np.errstate(invalid="ignore", divide="ignore"):
        k = np.where(small, 0.5 - theta**2 / 48.0, np.sin(half) / np.where(small, 1.0, theta))
    return np.concatenate([rvecs * k, np.cos(half)], axis=1)


def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamilton product of quaternions in (x,y,z,w) order; broadcasts."""
    ax, ay, az, aw = np.moveaxis(a, -1, 0)
    bx, by, bz, bw = np.moveaxis(b, -1, 0)
    return np.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    )


def _undistort(obs_over_f: np.ndarray, k1: np.ndarray, k2: np.ndarray) -> np.ndarray:
    """Invert d = r(|p|) * p for p (normalized coords), vectorized Newton.

    Solves g(rho) = rho*(1 + k1*rho^2 + k2*rho^4) - rho_d = 0 from
    rho = rho_d; BAL distortion is mild (|k1| ~ 1e-2 at |p| < 1) so 6
    iterations reach fp64 roundoff.
    """
    rho_d = np.linalg.norm(obs_over_f, axis=1)
    rho = rho_d.copy()
    for _ in range(6):
        r2 = rho * rho
        g = rho * (1.0 + r2 * (k1 + k2 * r2)) - rho_d
        dg = 1.0 + r2 * (3.0 * k1 + 5.0 * k2 * r2)
        rho = rho - g / dg
    scale = np.where(rho_d > 0, rho / np.where(rho_d > 0, rho_d, 1.0), 1.0)
    return obs_over_f * scale[:, None]


def _read_tokens(path: str) -> np.ndarray:
    """All whitespace-separated floats in the (optionally gzipped) file."""
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            return np.array(f.read().split(), dtype=np.float64)
    with open(path) as f:
        return np.fromfile(f, sep=" ")


def read_bal(
    path: str,
    config=None,
    fix_first_pose: bool = True,
    undistort: bool = True,
    information: float = 1.0,
) -> BundleAdjustment:
    """Load a BAL problem file (optionally .gz) into a BundleAdjustment graph
    of ``config`` (a ``BAConfig``; the default runs on the card).

    Camera vertices get ids ``0..n_cams-1`` and landmark vertices
    ``n_cams..n_cams+n_pts-1`` (BAL indices are namespaced per type; the
    graph API shares one id space per vertex kind so no offset is actually
    required for landmarks, but a disjoint range keeps debugging sane).
    """
    tok = _read_tokens(path)
    if tok.size < 3:
        raise ValueError(f"{path}: not a BAL file (fewer than 3 header tokens)")
    n_cams, n_pts, n_obs = (int(x) for x in tok[:3])
    want = 3 + 4 * n_obs + 9 * n_cams + 3 * n_pts
    if tok.size != want:
        raise ValueError(
            f"{path}: BAL token count mismatch: header promises {want} tokens "
            f"({n_cams} cams / {n_pts} pts / {n_obs} obs), file has {tok.size}"
        )
    obs = tok[3 : 3 + 4 * n_obs].reshape(n_obs, 4)
    cams = tok[3 + 4 * n_obs : 3 + 4 * n_obs + 9 * n_cams].reshape(n_cams, 9)
    pts = tok[3 + 4 * n_obs + 9 * n_cams :].reshape(n_pts, 3)

    cam_idx = obs[:, 0].astype(np.int64)
    pt_idx = obs[:, 1].astype(np.int64)
    if cam_idx.min(initial=0) < 0 or (n_obs and cam_idx.max() >= n_cams):
        raise ValueError(f"{path}: observation camera index out of range")
    if pt_idx.min(initial=0) < 0 or (n_obs and pt_idx.max() >= n_pts):
        raise ValueError(f"{path}: observation point index out of range")

    f = cams[:, 6]
    k1, k2 = cams[:, 7], cams[:, 8]
    qs = _quat_mul(_FLIP_Q, _rodrigues_to_quat(cams[:, 0:3]))  # R' = M R
    ts = cams[:, 3:6] @ _FLIP_M.T  # t' = M t

    meas = obs[:, 2:4].copy()
    if np.any(k1 != 0.0) or np.any(k2 != 0.0):
        if not undistort:
            raise ValueError(
                f"{path}: nonzero radial distortion (k1/k2) but undistort=False; "
                "the pinhole model cannot represent it exactly"
            )
        fe = f[cam_idx]
        meas = _undistort(meas / fe[:, None], k1[cam_idx], k2[cam_idx]) * fe[:, None]
    meas[:, 0] *= -1.0  # BAL -z convention -> +z pinhole (see module docstring)

    ba = BundleAdjustment(config)
    for i in range(n_cams):
        ba.add_pose_vertex(
            PoseVertex(
                i,
                qs[i],
                ts[i],
                CameraParams(fx=float(f[i]), fy=float(f[i]), cx=0.0, cy=0.0, bf=0.0),
                fixed=(fix_first_pose and i == 0),
            )
        )
    for j in range(n_pts):
        ba.add_landmark_vertex(LandmarkVertex(n_cams + j, pts[j]))
    for e in range(n_obs):
        ba.add_monocular_edge(
            MonoEdge(
                meas[e],
                information,
                ba.pose_vertex(int(cam_idx[e])),
                ba.landmark_vertex(n_cams + int(pt_idx[e])),
            )
        )
    return ba


def write_bal(ba: BundleAdjustment, path: str) -> None:
    """Write a mono-only graph in BAL text format (inverse of read_bal).

    Poses are converted back to the BAL -z convention (R = M^-1 R',
    t = M^-1 t') and measurements to (-x, y); distortion is written as 0.
    Useful for round-trip tests and exporting problems to ceres/BAL tools.
    """
    if ba._stereo_edges:
        raise ValueError("BAL format has no stereo observations")
    pids = sorted(ba._poses)
    lids = sorted(ba._landmarks)
    prow = {pid: i for i, pid in enumerate(pids)}
    lrow = {lid: j for j, lid in enumerate(lids)}
    edges = list(ba._mono_edges)
    with open(path, "w") as fh:
        fh.write(f"{len(pids)} {len(lids)} {len(edges)}\n")
        for e in edges:
            fh.write(
                f"{prow[e.vertexP.id]} {lrow[e.vertexL.id]} "
                f"{-e.measurement[0]:.17g} {e.measurement[1]:.17g}\n"
            )
        for pid in pids:
            v = ba.pose_vertex(pid)
            q = _quat_mul(_FLIP_Q, np.asarray(v.q, np.float64))  # M^-1 = M
            # quat -> axis-angle: theta = 2*atan2(|xyz|, w), axis = xyz/|xyz|
            xyz, w = q[:3], q[3]
            s = np.linalg.norm(xyz)
            theta = 2.0 * np.arctan2(s, w)
            rvec = xyz * (theta / s) if s > 1e-12 else xyz * 2.0
            t = _FLIP_M @ np.asarray(v.t, np.float64)
            for val in (*rvec, *t, v.camera.fx, 0.0, 0.0):
                fh.write(f"{val:.17g}\n")
        for lid in lids:
            for val in ba.landmark_vertex(lid).Xw:
                fh.write(f"{val:.17g}\n")
