"""Write the repository's BAL-format fixtures: ``data/bal_toy.txt.gz`` and,
with ``--ladybug-scale``, ``data/bal_ladybug_scale.txt.gz``.

    python -m cuba_tpu_torch.tools.make_bal_fixture [out.txt.gz]
    python -m cuba_tpu_torch.tools.make_bal_fixture --ladybug-scale [out.txt.gz]

The public BAL archives are not redistributable inside the repository, so
it holds synthetic problems written in the genuine BAL text format: a ring
of cameras orbiting a blob of points, BAL's -z projection convention,
radial distortion (k1, k2), noisy observations and perturbed initial
estimates, which exercise everything the reader must handle in a real
download (Rodrigues rotations, the -z convention, per-camera focal
lengths, distortion).  ``--ladybug-scale`` gives Ladybug-49's published
shape (49 cameras, 7,776 points, ~31.8k observations) with its local
covisibility and barrel distortion.  NumPy and SciPy only: no device.
The text is a function of the seed alone (the gzip header carries a
time, so compare the decompressed text).
"""

import argparse
import gzip
import sys

import numpy as np

TOY = "data/bal_toy.txt.gz"
LADYBUG = "data/bal_ladybug_scale.txt.gz"


def rot_look_at_origin(C: np.ndarray, up_hint=np.array([0.0, 1.0, 0.0])) -> np.ndarray:
    """World-to-camera rotation whose -z axis points from the camera centre
    C toward the world origin (the BAL viewing convention)."""
    fwd = -C / np.linalg.norm(C)
    zc = -fwd  # camera +z axis, in world coordinates
    right = np.cross(up_hint, zc)
    right = right / np.linalg.norm(right)
    up = np.cross(zc, right)
    return np.stack([right, up, zc])  # rows = camera axes


def mat_to_rodrigues(R: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    return Rotation.from_matrix(R).as_rotvec()


def generate(n_cams=20, n_pts=500, seed=3, noise_px=0.4, clustered=False, obs_per_pt=None):
    """(initial cameras [n_cams, 9], initial points [n_pts, 3], observations
    [(camera, point, x, y)]).  ``clustered=True`` gives Ladybug-like
    covisibility: each point is anchored near one ring angle and seen only
    by the cameras in a local angular window, with consumer-lens barrel
    distortion (several percent at the image edge)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(scale=2.0, size=(n_pts, 3))
    ang = np.linspace(0, 2 * np.pi, n_cams, endpoint=False)
    centers = np.stack([10 * np.cos(ang), 0.5 * np.sin(3 * ang), 10 * np.sin(ang)], axis=1)
    f = rng.uniform(800.0, 1200.0, size=n_cams)
    if clustered:
        # normalized radius up to ~0.6 (r2 ~ 0.36): k1 r2 ~ -5..-9%, k2 r4
        # ~ +0.1%, inside the range where r(p) |p| is monotonic
        pt_ang = rng.uniform(0, 2 * np.pi, n_pts)
        radial = rng.uniform(4.5, 7.5, n_pts)
        pts = np.stack([radial * np.cos(pt_ang), rng.normal(scale=0.6, size=n_pts),
                        radial * np.sin(pt_ang)], axis=1)
        f = rng.uniform(380.0, 420.0, size=n_cams)
        k1 = rng.uniform(-0.25, -0.15, size=n_cams)
        k2 = rng.uniform(0.003, 0.01, size=n_cams)
    else:
        pt_ang = None
        k1 = rng.uniform(-5e-2, -1e-2, size=n_cams)
        k2 = rng.uniform(1e-3, 5e-3, size=n_cams)

    cams = np.zeros((n_cams, 9))
    Rs, ts = [], []
    for i in range(n_cams):
        R = rot_look_at_origin(centers[i])
        t = -R @ centers[i]
        Rs.append(R)
        ts.append(t)
        cams[i, 0:3] = mat_to_rodrigues(R)
        cams[i, 3:6] = t
        cams[i, 6:9] = (f[i], k1[i], k2[i])

    obs = []
    for i in range(n_cams):
        P = pts @ Rs[i].T + ts[i]  # Pz < 0 by construction
        p = -P[:, :2] / P[:, 2:3]  # ideal normalized (BAL convention)
        r2 = np.sum(p * p, axis=1)
        d = f[i] * (1.0 + k1[i] * r2 + k2[i] * r2 * r2)[:, None] * p
        if pt_ang is not None:
            # camera i sees the points anchored within a window of ~1.5x
            # the target cameras a point, two thirds of them
            dang = np.abs((pt_ang - ang[i] + np.pi) % (2 * np.pi) - np.pi)
            target = obs_per_pt if obs_per_pt else 4.1
            halfwin = 1.5 * target * np.pi / n_cams
            vis = (dang < halfwin) & (rng.random(n_pts) < 2.0 / 3.0)
            vis &= P[:, 2] < -0.5  # in front of the BAL camera
        else:
            vis = rng.random(n_pts) < 0.5  # a random half of the points
        for j in np.flatnonzero(vis):
            obs.append((i, j, d[j, 0] + rng.normal(scale=noise_px),
                        d[j, 1] + rng.normal(scale=noise_px)))

    # perturbed initial estimates (clustered: ~10x rougher, as real SfM
    # initials start at several px of reprojection error)
    pscale = 10.0 if clustered else 1.0
    cams_init = cams.copy()
    cams_init[:, 0:3] += rng.normal(scale=2e-3 * pscale, size=(n_cams, 3))
    cams_init[:, 3:6] += rng.normal(scale=2e-2 * pscale, size=(n_cams, 3))
    pts_init = pts + rng.normal(scale=2e-2 * pscale, size=pts.shape)
    return cams_init, pts_init, obs


def text(cams, pts, obs) -> str:
    """The problem in BAL's text format."""
    lines = [f"{len(cams)} {len(pts)} {len(obs)}\n"]
    lines += [f"{i} {j} {x:.12g} {y:.12g}\n" for i, j, x, y in obs]
    lines += [f"{v:.17g}\n" for c in cams for v in c]
    lines += [f"{v:.17g}\n" for p in pts for v in p]
    return "".join(lines)


def write(path: str, cams, pts, obs) -> None:
    """Write the problem to ``path``, gzip-compressed where it ends in .gz."""
    op = gzip.open(path, "wt") if path.endswith(".gz") else open(path, "w")
    with op as fh:
        fh.write(text(cams, pts, obs))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ladybug-scale", action="store_true")
    ap.add_argument("out", nargs="?", default=None)
    args = ap.parse_args(argv)
    if args.ladybug_scale:
        out = args.out or LADYBUG
        cams, pts, obs = generate(n_cams=49, n_pts=7776, seed=7, noise_px=0.6, clustered=True)
    else:
        out = args.out or TOY
        cams, pts, obs = generate()
    write(out, cams, pts, obs)
    print(f"wrote {out}: {len(cams)} cams / {len(pts)} pts / {len(obs)} obs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
