"""Synthetic bundle-adjustment problem generators.

A NumPy copy of ``cuba_tpu/io/synthetic.py``: the same seed gives the same
problem in both packages.  ``build_graph`` builds the port's graph.

The reference's fixtures (ba_kitti_00/07.json, extracted from ORB-SLAM2 on
KITTI; reference: README.md:101-104) are not in its checkout, so we generate
statistically similar problems: a camera trajectory, a landmark cloud, and
mono/stereo observations with Gaussian pixel noise, plus perturbed initial
estimates so the optimizer has real work to do.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticProblem:
    """Ground truth + noisy initialization for a BA problem."""

    # ground truth
    gt_qs: np.ndarray  # [P,4] (x,y,z,w) world-to-camera
    gt_ts: np.ndarray  # [P,3]
    gt_Xws: np.ndarray  # [L,3]
    # noisy initial estimates
    qs: np.ndarray
    ts: np.ndarray
    Xws: np.ndarray
    # observations
    cam: np.ndarray  # [5] fx fy cx cy bf (shared camera)
    mono_p: np.ndarray  # [E2] pose id per mono edge
    mono_l: np.ndarray  # [E2] landmark id
    mono_z: np.ndarray  # [E2,2] measurement
    mono_w: np.ndarray  # [E2] information scalar
    stereo_p: np.ndarray
    stereo_l: np.ndarray
    stereo_z: np.ndarray  # [E3,3]
    stereo_w: np.ndarray
    fixed_poses: np.ndarray  # pose ids held fixed


def _quat_from_small_rotvec(w: np.ndarray) -> np.ndarray:
    """Rotation vectors -> quaternions (x,y,z,w)."""
    theta = np.linalg.norm(w, axis=-1, keepdims=True)
    theta = np.maximum(theta, 1e-30)
    axis = w / theta
    half = 0.5 * theta
    return np.concatenate([axis * np.sin(half), np.cos(half)], axis=-1)


def _quat_mul(a, b):
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by + ay * bw + az * bx - ax * bz,
            aw * bz + az * bw + ax * by - ay * bx,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    )


def _quat_rotate(q, v):
    qv, w = q[..., :3], q[..., 3:4]
    t = 2.0 * np.cross(qv, v)
    return v + w * t + np.cross(qv, t)


def generate(
    num_poses: int = 30,
    num_landmarks: int = 500,
    mean_obs_per_landmark: float = 5.0,
    stereo_fraction: float = 0.3,
    pixel_noise: float = 1.0,
    init_rot_noise: float = 0.005,
    init_trans_noise: float = 0.05,
    init_point_noise: float = 0.10,
    num_fixed_poses: int = 1,
    seed: int = 0,
    image_size: Tuple[int, int] = (1226, 370),
    loop_closure: bool = False,
) -> SyntheticProblem:
    """KITTI-like forward-motion scene with co-visibility windows.

    Landmarks are anchored near a random trajectory point and observed from a
    window of nearby poses — this reproduces the banded co-observation
    structure that makes the Schur complement sparse on real SLAM data.

    ``loop_closure=True`` drives the trajectory around a closed circuit and
    lets the covisibility window WRAP at the seam, so the last poses
    genuinely re-observe the first landmarks from physically revisited
    viewpoints — the ORB-SLAM loop-closure covisibility shape of the
    reference's real KITTI-00 fixture (reference: README.md:101-104).  The
    resulting Schur pattern is "banded + corner blocks", which
    solver="auto" routes to the band+Woodbury solver (band_cr.
    cr_solve_woodbury) instead of the dense factorization.
    """
    rng = np.random.default_rng(seed)
    fx = fy = 718.856
    cx, cy = 607.1928, 185.2157
    bf = 386.1448
    cam = np.array([fx, fy, cx, cy, bf])
    W, H = image_size

    speed = 1.0
    centers = np.zeros((num_poses, 3))
    headings = np.zeros(num_poses)
    if loop_closure:
        # closed circuit: heading sweeps exactly 2*pi over the trajectory,
        # so pose P-1 returns next to pose 0 (the loop-closure seam)
        headings = 2.0 * np.pi * np.arange(num_poses) / num_poses
        headings += rng.normal(0, 0.002, num_poses)
        for i in range(1, num_poses):
            step = speed * np.array(
                [np.sin(headings[i]), 0.0, np.cos(headings[i])]
            )
            centers[i] = centers[i - 1] + step + rng.normal(0, 0.01, 3)
    else:
        # open trajectory: mostly forward (+z in world), slight curvature
        for i in range(1, num_poses):
            headings[i] = headings[i - 1] + rng.normal(0, 0.02)
            step = speed * np.array([np.sin(headings[i]), 0.0, np.cos(headings[i])])
            centers[i] = centers[i - 1] + step + rng.normal(0, 0.01, 3)

    # camera orientation: yaw = heading (world-to-camera = R^T, -R^T c)
    half = 0.5 * headings
    R_wc_q = np.stack(
        [np.zeros(num_poses), np.sin(half), np.zeros(num_poses), np.cos(half)], axis=-1
    )  # camera-to-world rotation about y
    # world-to-camera quaternion = conjugate
    gt_qs = R_wc_q * np.array([-1.0, -1.0, -1.0, 1.0])
    gt_ts = -_quat_rotate(gt_qs, centers)

    # landmarks: anchored to a trajectory point, offset forward and sideways
    anchor = rng.integers(0, num_poses, num_landmarks)
    ahead = rng.uniform(4.0, 30.0, num_landmarks)
    side = rng.uniform(-15.0, 15.0, num_landmarks)
    height = rng.uniform(-2.0, 5.0, num_landmarks)
    h = headings[anchor]
    fwd = np.stack([np.sin(h), np.zeros_like(h), np.cos(h)], axis=-1)
    lat = np.stack([np.cos(h), np.zeros_like(h), -np.sin(h)], axis=-1)
    up = np.array([0.0, 1.0, 0.0])
    gt_Xws = centers[anchor] + ahead[:, None] * fwd + side[:, None] * lat + height[:, None] * up

    # observations: window of poses around the anchor (vectorized: each
    # in-window pose observes the landmark with probability keeping the mean)
    win = max(int(round(mean_obs_per_landmark)), 1)
    keep_p = min(mean_obs_per_landmark / (2 * win + 1), 1.0)
    offsets = np.arange(-win, win + 1)
    cand_p = anchor[:, None] + offsets[None, :]  # [L, 2w+1]
    keep = rng.random(cand_p.shape) < keep_p
    keep[:, win] = True  # anchor pose always observes (>= 1 obs/landmark)
    if loop_closure:
        # covisibility wraps at the seam: late poses re-observe early
        # landmarks (and vice versa) — the loop-closure edges
        cand_p = np.mod(cand_p, num_poses)
    keep &= (cand_p >= 0) & (cand_p < num_poses)
    obs_l, obs_k = np.nonzero(keep)
    obs_p = cand_p[obs_l, obs_k].astype(np.int64)
    obs_l = obs_l.astype(np.int64)

    # project, keep in-frustum observations
    Xc = _quat_rotate(gt_qs[obs_p], gt_Xws[obs_l]) + gt_ts[obs_p]
    valid = Xc[:, 2] > 0.5
    obs_p, obs_l, Xc = obs_p[valid], obs_l[valid], Xc[valid]
    inv_z = 1.0 / Xc[:, 2]
    u = fx * inv_z * Xc[:, 0] + cx
    v = fy * inv_z * Xc[:, 1] + cy
    infr = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    obs_p, obs_l, Xc, u, v, inv_z = (
        obs_p[infr],
        obs_l[infr],
        Xc[infr],
        u[infr],
        v[infr],
        inv_z[infr],
    )

    nobs = obs_p.size
    is_stereo = rng.random(nobs) < stereo_fraction
    noise = rng.normal(0, pixel_noise, (nobs, 3))

    mono_sel = ~is_stereo
    mono_z = np.stack([u[mono_sel] + noise[mono_sel, 0], v[mono_sel] + noise[mono_sel, 1]], axis=-1)
    stereo_sel = is_stereo
    ur = u[stereo_sel] - bf * inv_z[stereo_sel]
    stereo_z = np.stack(
        [
            u[stereo_sel] + noise[stereo_sel, 0],
            v[stereo_sel] + noise[stereo_sel, 1],
            ur + noise[stereo_sel, 2],
        ],
        axis=-1,
    )

    inv_sigma2 = 1.0 / (pixel_noise * pixel_noise) if pixel_noise > 0 else 1.0

    # noisy initialization (fixed poses keep ground truth).  The rotation
    # perturbation is applied ABOUT THE CAMERA CENTER: perturbing q while
    # keeping t (a world-to-camera translation) rotates the camera about
    # the WORLD ORIGIN, which lever-arms a ~1e-3 rad noise into tens of
    # meters of camera-frame error at km-long trajectories — flipping
    # point depths negative and NaN-ing the projective residuals.  Real
    # SLAM initializations err locally, not about the map origin.
    dq = _quat_from_small_rotvec(rng.normal(0, init_rot_noise, (num_poses, 3)))
    qs = _quat_mul(dq, gt_qs)
    qs /= np.linalg.norm(qs, axis=-1, keepdims=True)
    qs[qs[:, 3] < 0] *= -1
    conj = np.array([-1.0, -1.0, -1.0, 1.0])
    centers_gt = -_quat_rotate(gt_qs * conj, gt_ts)  # c = -R^T t
    centers_noisy = centers_gt + rng.normal(0, init_trans_noise, (num_poses, 3))
    ts = -_quat_rotate(qs, centers_noisy)
    Xws = gt_Xws + rng.normal(0, init_point_noise, (num_landmarks, 3))

    fixed = np.arange(min(num_fixed_poses, num_poses))
    qs[fixed] = gt_qs[fixed]
    ts[fixed] = gt_ts[fixed]

    return SyntheticProblem(
        gt_qs=gt_qs,
        gt_ts=gt_ts,
        gt_Xws=gt_Xws,
        qs=qs,
        ts=ts,
        Xws=Xws,
        cam=cam,
        mono_p=obs_p[mono_sel],
        mono_l=obs_l[mono_sel],
        mono_z=mono_z,
        mono_w=np.full(mono_sel.sum(), inv_sigma2),
        stereo_p=obs_p[stereo_sel],
        stereo_l=obs_l[stereo_sel],
        stereo_z=stereo_z,
        stereo_w=np.full(stereo_sel.sum(), inv_sigma2),
        fixed_poses=fixed,
    )


def build_graph(problem: SyntheticProblem, config=None):
    """Materialize a SyntheticProblem into a BundleAdjustment graph."""
    from cuba_tpu_torch.models.graph import BundleAdjustment
    from cuba_tpu_torch.models.types import (
        CameraParams, LandmarkVertex, MonoEdge, PoseVertex, StereoEdge,
    )

    cam = CameraParams(*problem.cam)
    ba = BundleAdjustment(config)
    fixed = set(problem.fixed_poses.tolist())
    for i in range(problem.qs.shape[0]):
        ba.add_pose_vertex(PoseVertex(i, problem.qs[i], problem.ts[i], cam, fixed=i in fixed))
    for j in range(problem.Xws.shape[0]):
        ba.add_landmark_vertex(LandmarkVertex(j, problem.Xws[j]))
    for p, l, z, w in zip(problem.mono_p, problem.mono_l, problem.mono_z, problem.mono_w):
        ba.add_monocular_edge(
            MonoEdge(z, w, ba.pose_vertex(int(p)), ba.landmark_vertex(int(l)))
        )
    for p, l, z, w in zip(problem.stereo_p, problem.stereo_l, problem.stereo_z, problem.stereo_w):
        ba.add_stereo_edge(
            StereoEdge(z, w, ba.pose_vertex(int(p)), ba.landmark_vertex(int(l)))
        )
    return ba
