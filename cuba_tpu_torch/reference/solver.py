"""Pure NumPy/SciPy bundle-adjustment reference solver: the fp64 oracle
(a copy of ``cuba_tpu/reference/solver.py``, which cannot be imported
without JAX; ``tests/test_torch_api.py`` holds the two equal bit for bit).

Plays the role g2o plays for the reference project (reference:
samples/sample_comparison_with_g2o.cpp:181-184 — BlockSolver_6_3 + dense/
Eigen linear solver + OptimizationAlgorithmLevenberg): an INDEPENDENT
implementation of the same estimation problem used to validate per-iteration
chi2 and final estimates of the engine to fp64 precision.

Independence from the engine is deliberate:
  * SE(3) exponential via ``scipy.linalg.expm`` of the 4x4 twist (not the
    closed-form Rodrigues/V-matrix path),
  * rotations handled with ``scipy.spatial.transform.Rotation``,
  * the full (6P+3L) sparse normal system assembled in scipy.sparse and
    solved directly with a sparse LDL/LU factorization — no Schur
    complement, no segment_sum, no padding.

Only the problem definition (residual/Jacobian/robust-kernel conventions)
and the LM control law (cuda_bundle_adjustment.cpp:793-857) are shared,
because those define the algorithm being checked.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import scipy.linalg
import scipy.sparse
import scipy.sparse.linalg
from scipy.spatial.transform import Rotation


@dataclasses.dataclass
class RefProblem:
    """Dense problem description (internal indices, active-first)."""

    num_p: int
    num_l: int
    qs: np.ndarray  # [total_p,4] (x,y,z,w)
    ts: np.ndarray  # [total_p,3]
    cams: np.ndarray  # [total_p,5]
    Xws: np.ndarray  # [total_l,3]
    mono_p: np.ndarray
    mono_l: np.ndarray
    mono_z: np.ndarray
    mono_w: np.ndarray
    stereo_p: np.ndarray
    stereo_l: np.ndarray
    stereo_z: np.ndarray
    stereo_w: np.ndarray
    kernels: Tuple[Tuple[int, float], Tuple[int, float]] = ((0, 0.0), (0, 0.0))

    @classmethod
    def from_structure(cls, s, kernels) -> "RefProblem":
        return cls(
            num_p=s.num_p,
            num_l=s.num_l,
            qs=s.qs.copy(),
            ts=s.ts.copy(),
            cams=s.cams.copy(),
            Xws=s.Xws.copy(),
            mono_p=s.mono.pose_idx.astype(int),
            mono_l=s.mono.lm_idx.astype(int),
            mono_z=s.mono.measurements,
            mono_w=s.mono.omegas,
            stereo_p=s.stereo.pose_idx.astype(int),
            stereo_l=s.stereo.lm_idx.astype(int),
            stereo_z=s.stereo.measurements,
            stereo_w=s.stereo.omegas,
            kernels=tuple((int(k[0]), float(k[1])) for k in kernels),
        )


def _rho_and_weight(x: np.ndarray, ktype: int, delta: float):
    if ktype == 0:
        return x, np.ones_like(x)
    d2 = delta * delta
    if ktype == 1:  # Huber
        over = x > d2
        rho = np.where(over, 2.0 * np.sqrt(np.maximum(x, d2)) * delta - d2, x)
        w = np.where(over, delta / np.sqrt(np.maximum(x, d2)), 1.0)
        return rho, w
    if ktype == 2:  # Tukey
        over = x > d2
        maxv = d2 / 3.0
        rho = np.where(over, maxv, maxv * (1.0 - (1.0 - x / d2) ** 3))
        w = np.where(over, 0.0, (1.0 - x / d2) ** 2)
        return rho, w
    raise ValueError(ktype)


class ReferenceSolver:
    """Levenberg-Marquardt over the full sparse normal equations."""

    def __init__(self, problem: RefProblem):
        self.p = problem
        self.chi_history: List[float] = []

    # --- model -----------------------------------------------------------

    def _project(self, qs, ts, Xws, pi, li, stereo: bool):
        R = Rotation.from_quat(qs[pi])
        Xc = R.apply(Xws[li]) + ts[pi]
        cam = self.p.cams[pi]
        inv_z = 1.0 / Xc[:, 2]
        u = cam[:, 0] * inv_z * Xc[:, 0] + cam[:, 2]
        v = cam[:, 1] * inv_z * Xc[:, 1] + cam[:, 3]
        if stereo:
            return np.stack([u, v, u - cam[:, 4] * inv_z], axis=-1), Xc
        return np.stack([u, v], axis=-1), Xc

    def _residuals(self, qs, ts, Xws):
        out = []
        for pi, li, z, stereo in (
            (self.p.mono_p, self.p.mono_l, self.p.mono_z, False),
            (self.p.stereo_p, self.p.stereo_l, self.p.stereo_z, True),
        ):
            if pi.size:
                proj, Xc = self._project(qs, ts, Xws, pi, li, stereo)
                out.append((proj - z, Xc))
            else:
                out.append((np.zeros((0, 3 if stereo else 2)), np.zeros((0, 3))))
        return out

    def chi2(self, qs=None, ts=None, Xws=None) -> float:
        qs = self.p.qs if qs is None else qs
        ts = self.p.ts if ts is None else ts
        Xws = self.p.Xws if Xws is None else Xws
        (e2, _), (e3, _) = self._residuals(qs, ts, Xws)
        total = 0.0
        for err, w, kern in ((e2, self.p.mono_w, self.p.kernels[0]), (e3, self.p.stereo_w, self.p.kernels[1])):
            if err.shape[0]:
                x = w * np.sum(err * err, axis=-1)
                rho, _ = _rho_and_weight(x, kern[0], kern[1])
                total += float(rho.sum())
        return total

    def _jacobians(self, qs, Xc, pi, stereo: bool):
        """Analytic JP (E,m,6) / JL (E,m,3), same sign convention as the
        engine (negated residual derivative wrt left increment)."""
        cam = self.p.cams[pi]
        fu, fv = cam[:, 0], cam[:, 1]
        X, Y, Z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
        iz = 1.0 / Z
        izz = iz * iz
        R = Rotation.from_quat(qs[pi]).as_matrix()  # [E,3,3]

        m = 3 if stereo else 2
        E = Xc.shape[0]
        JP = np.zeros((E, m, 6))
        JL = np.zeros((E, m, 3))

        # landmark block: -d(proj)/dXc @ R
        JL[:, 0, :] = -(fu * iz)[:, None] * (R[:, 0, :] - (X * iz)[:, None] * R[:, 2, :])
        JL[:, 1, :] = -(fv * iz)[:, None] * (R[:, 1, :] - (Y * iz)[:, None] * R[:, 2, :])
        # pose block (omega | upsilon)
        JP[:, 0, 0] = fu * X * Y * izz
        JP[:, 0, 1] = -fu * (1 + X * X * izz)
        JP[:, 0, 2] = fu * Y * iz
        JP[:, 0, 3] = -fu * iz
        JP[:, 0, 5] = fu * X * izz
        JP[:, 1, 0] = fv * (1 + Y * Y * izz)
        JP[:, 1, 1] = -fv * X * Y * izz
        JP[:, 1, 2] = -fv * X * iz
        JP[:, 1, 4] = -fv * iz
        JP[:, 1, 5] = fv * Y * izz
        if stereo:
            bf = cam[:, 4]
            JL[:, 2, :] = JL[:, 0, :] - (bf * izz)[:, None] * R[:, 2, :]
            JP[:, 2, :] = JP[:, 0, :]
            JP[:, 2, 0] -= bf * Y * izz
            JP[:, 2, 1] += bf * X * izz
            JP[:, 2, 4] = 0.0
            JP[:, 2, 5] -= bf * izz
        return JP, JL

    def _build_normal_system(self, qs, ts, Xws):
        """Full sparse H (6P+3L square) and b via COO accumulation."""
        P, L = self.p.num_p, self.p.num_l
        n = 6 * P + 3 * L
        rows, cols, vals = [], [], []
        b = np.zeros(n)

        (e2, Xc2), (e3, Xc3) = self._residuals(qs, ts, Xws)
        for err, Xc, pi, li, w, kern, stereo in (
            (e2, Xc2, self.p.mono_p, self.p.mono_l, self.p.mono_w, self.p.kernels[0], False),
            (e3, Xc3, self.p.stereo_p, self.p.stereo_l, self.p.stereo_w, self.p.kernels[1], True),
        ):
            if not err.shape[0]:
                continue
            x = w * np.sum(err * err, axis=-1)
            _, rw = _rho_and_weight(x, kern[0], kern[1])
            wt = w * rw
            JP, JL = self._jacobians(qs, Xc, pi, stereo)
            free_p = pi < P
            free_l = li < L

            HppE = np.einsum("e,eki,ekj->eij", wt, JP, JP)
            bpE = np.einsum("e,eki,ek->ei", wt, JP, err)
            HllE = np.einsum("e,eki,ekj->eij", wt, JL, JL)
            blE = np.einsum("e,eki,ek->ei", wt, JL, err)
            HplE = np.einsum("e,eki,ekj->eij", wt, JP, JL)

            def emit_block(r0, c0, blk, mask):
                br, bc = blk.shape[1], blk.shape[2]
                rr = (r0[:, None, None] + np.arange(br)[None, :, None]).repeat(bc, 2)
                cc = (c0[:, None, None] + np.arange(bc)[None, None, :]).repeat(br, 1)
                rows.append(rr[mask].ravel())
                cols.append(cc[mask].ravel())
                vals.append(blk[mask].ravel())

            emit_block(6 * pi, 6 * pi, HppE, free_p)
            emit_block(6 * P + 3 * li, 6 * P + 3 * li, HllE, free_l)
            both = free_p & free_l
            emit_block(6 * pi, 6 * P + 3 * li, HplE, both)
            emit_block(6 * P + 3 * li, 6 * pi, np.swapaxes(HplE, 1, 2), both)

            np.add.at(b, (6 * pi[free_p, None] + np.arange(6)[None, :]).ravel(), bpE[free_p].ravel())
            np.add.at(
                b, (6 * P + 3 * li[free_l, None] + np.arange(3)[None, :]).ravel(), blE[free_l].ravel()
            )

        H = scipy.sparse.coo_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(n, n)
        ).tocsc()
        return H, b

    @staticmethod
    def _se3_exp_matrix(delta: np.ndarray) -> np.ndarray:
        """4x4 exp of the twist [omega, upsilon] via scipy expm."""
        w, u = delta[:3], delta[3:]
        xi = np.zeros((4, 4))
        xi[:3, :3] = [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]
        xi[:3, 3] = u
        return scipy.linalg.expm(xi)

    def _apply(self, qs, ts, Xws, dx):
        P, L = self.p.num_p, self.p.num_l
        qs, ts, Xws = qs.copy(), ts.copy(), Xws.copy()
        for i in range(P):
            T = self._se3_exp_matrix(dx[6 * i : 6 * i + 6])
            R_old = Rotation.from_quat(qs[i]).as_matrix()
            R_new = T[:3, :3] @ R_old
            t_new = T[:3, :3] @ ts[i] + T[:3, 3]
            q = Rotation.from_matrix(R_new).as_quat()
            if q[3] < 0:
                q = -q
            qs[i] = q
            ts[i] = t_new
        Xws[:L] += dx[6 * P :].reshape(L, 3)
        return qs, ts, Xws

    # --- LM driver (control law of cuda_bundle_adjustment.cpp:793-857) ----

    def optimize(self, niterations: int, max_inner: int = 10, tau: float = 1e-5):
        p = self.p
        qs, ts, Xws = p.qs, p.ts, p.Xws
        nu, lam = 2.0, 0.0
        self.chi_history = []
        for it in range(niterations):
            F = self.chi2(qs, ts, Xws)
            H, b = self._build_normal_system(qs, ts, Xws)
            if it == 0:
                lam = tau * max(H.diagonal().max(), 0.0)
            q_try, rho = 0, -1.0
            n = H.shape[0]
            while q_try < max_inner and rho < 0:
                Hd = H + lam * scipy.sparse.identity(n, format="csc")
                try:
                    dx = scipy.sparse.linalg.spsolve(Hd, b)
                    ok = bool(np.all(np.isfinite(dx)))
                except Exception:
                    dx, ok = np.zeros(n), False
                qs2, ts2, Xws2 = self._apply(qs, ts, Xws, dx)
                Fhat = self.chi2(qs2, ts2, Xws2)
                scale = float(dx @ (lam * dx + b)) + 1e-3
                rho = (F - Fhat) / scale if ok else -1.0
                if rho > 0:
                    lam *= float(np.clip(1 - (2 * rho - 1) ** 3, 1.0 / 3, 2.0 / 3))
                    nu = 2.0
                    F = Fhat
                    qs, ts, Xws = qs2, ts2, Xws2
                    break
                lam *= nu
                nu *= 2.0
                q_try += 1
            self.chi_history.append(F)
            if q_try == max_inner or rho <= 0 or not np.isfinite(lam):
                break
        p.qs, p.ts, p.Xws = qs, ts, Xws
        return self.chi_history
