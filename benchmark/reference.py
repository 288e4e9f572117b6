"""The plain reference that decides ``correct``: Levenberg-Marquardt bundle
adjustment in plain PyTorch, written from the problem's definition and
importing nothing of the program.

It solves the same problem as the program (pinhole mono and stereo
reprojection residuals under Huber kernels, SE(3) poses updated by a left
increment, landmarks by addition, the first pose fixed) under the same LM
control law (lambda0 = tau * max diag, gain ratio with the step's predicted
decrease, attenuation 1 - (2 rho - 1)^3 clamped to [1/3, 2/3], nu doubling,
x8 escalation where the solve fails), but by its own route: rotation
matrices rather than quaternions, the pose exponential by
``torch.linalg.matrix_exp`` of the 4x4 twist, the Schur complement of the
landmarks formed densely from every ordered pair of one landmark's
observations, and a dense Cholesky factorisation of the reduced system.
No band, no padding, no reordering and no kernel.

It runs in the dtype it is given.  ``tf32=True`` rounds both operands of
every product to TF32 (10 mantissa bits) before an fp32 product: the
benchmark's control, the reference in the precision below fp32 with TF32
off.  The same rounding runs on the card and on the host.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

PAIR_CHUNK = 1 << 21  # ordered observation pairs per step of the Schur formation


@dataclasses.dataclass
class LMParams:
    tau: float = 1e-5
    max_inner: int = 10
    scale_eps: float = 1e-3
    attenuation_min: float = 1.0 / 3.0
    attenuation_max: float = 2.0 / 3.0
    escalation: float = 8.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to the nearest TF32 value (10 mantissa bits)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """[N, 4] (x, y, z, w) -> [N, 3, 3], the quaternion normalised first."""
    q = q / q.norm(dim=-1, keepdim=True)
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


def camera_centres(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """c = -R^T t of world-to-camera poses."""
    return -torch.einsum("pji,pj->pi", R, t)


class Reference:
    """One problem: observations in the caller's numbering, the initial
    state, the Huber thresholds, and the arithmetic (dtype, TF32)."""

    def __init__(self, qs, ts, cam, Xws, fixed_poses, mono, stereo, deltas, device,
                 dtype=torch.float64, tf32=False, lm: Optional[LMParams] = None):
        # every fp32 product exact to fp32 (TF32 only where ``tf32`` asks)
        torch.backends.cuda.matmul.allow_tf32 = False
        self.device, self.dtype, self.tf32 = torch.device(device), dtype, tf32
        self.lm = lm or LMParams()
        self.deltas = tuple(float(d) for d in deltas)

        def dev(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), device=self.device).to(dt)

        P, L = len(qs), len(Xws)
        self.P, self.L = P, L
        self.cam = dev(cam)
        free = np.ones(P, bool)
        free[np.asarray(fixed_poses, np.int64)] = False
        self.free_ids = dev(np.nonzero(free)[0], torch.int64)
        pidx = np.full(P, -1, np.int64)
        pidx[free] = np.arange(free.sum())
        self.Pf = int(free.sum())
        self.edges = []
        for (p, l, z, w) in (mono, stereo):
            p = np.asarray(p, np.int64)
            self.edges.append(dict(p=dev(p, torch.int64), l=dev(l, torch.int64),
                                   z=dev(z), w=dev(w), fp=dev(pidx[p], torch.int64)))
        self._plan_slots(pidx)
        self.R0, self.t0, self.X0 = quat_to_rot(dev(qs, torch.float64)).to(dtype), dev(ts), dev(Xws)

    # -- arithmetic ---------------------------------------------------------

    def mm(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            ops = tuple(round_tf32(o) for o in ops)
        return torch.einsum(eq, *ops)

    # -- the Schur pattern ----------------------------------------------------

    def _plan_slots(self, pidx: np.ndarray) -> None:
        """The (free pose, landmark) slots of every observation with a free
        pose, sorted by landmark, and every ordered pair of slots of one
        landmark."""
        keys, slot_of = [], []
        for e in self.edges:
            fp = e["fp"]
            keys.append(torch.where(fp >= 0, e["l"] * self.Pf + fp, torch.full_like(fp, -1)))
        allk = torch.cat(keys)
        uniq, inv = torch.unique(allk[allk >= 0], return_inverse=True)
        start = 0
        for e, k in zip(self.edges, keys):
            s = torch.full_like(k, -1)
            m = k >= 0
            s[m] = inv[start:start + int(m.sum())]
            start += int(m.sum())
            e["slot"] = s
        self.slot_l = uniq // self.Pf
        self.slot_p = uniq % self.Pf
        counts = torch.bincount(self.slot_l, minlength=self.L)
        first = torch.cumsum(counts, 0) - counts
        k = counts[self.slot_l]
        self.pair_s = torch.repeat_interleave(torch.arange(uniq.numel(), device=self.device), k)
        offs = torch.cumsum(k, 0) - k
        rank = torch.arange(self.pair_s.numel(), device=self.device) - offs[self.pair_s]
        self.pair_t = first[self.slot_l][self.pair_s] + rank

    # -- the model ------------------------------------------------------------

    def _linearise(self, R, t, X, e, stereo: bool, jacobians: bool):
        p, l = e["p"], e["l"]
        Rp = R[p]
        Xc = self.mm("eij,ej->ei", Rp, X[l]) + t[p]
        cam = self.cam
        fu, fv, cu, cv, bf = (cam[i] for i in range(5))
        Xx, Y, Z = Xc.unbind(-1)
        iz = 1.0 / Z
        u = fu * iz * Xx + cu
        v = fv * iz * Y + cv
        proj = [u, v] + ([u - bf * iz] if stereo else [])
        err = torch.stack(proj, -1) - e["z"]
        x = e["w"] * (err * err).sum(-1)
        delta = self.deltas[1 if stereo else 0]
        d2 = delta * delta
        over = x > d2
        xs = torch.maximum(x, torch.full_like(x, d2))
        rho = torch.where(over, 2.0 * torch.sqrt(xs) * delta - d2, x)
        if not jacobians:
            return rho
        rw = torch.where(over, delta / torch.sqrt(xs), torch.ones_like(x))
        izz = iz * iz
        zero = torch.zeros_like(Z)
        # the negated derivative of the residual: landmark, then the pose's
        # left increment (rotation, translation)
        JL = [-(fu * iz)[:, None] * (Rp[:, 0, :] - (Xx * iz)[:, None] * Rp[:, 2, :]),
              -(fv * iz)[:, None] * (Rp[:, 1, :] - (Y * iz)[:, None] * Rp[:, 2, :])]
        JP = [torch.stack([fu * Xx * Y * izz, -fu * (1 + Xx * Xx * izz), fu * Y * iz,
                           -fu * iz, zero, fu * Xx * izz], -1),
              torch.stack([fv * (1 + Y * Y * izz), -fv * Xx * Y * izz, -fv * Xx * iz,
                           zero, -fv * iz, fv * Y * izz], -1)]
        if stereo:
            JL.append(JL[0] - (bf * izz)[:, None] * Rp[:, 2, :])
            JP.append(JP[0] + torch.stack([-bf * Y * izz, bf * Xx * izz, zero, zero, zero,
                                           -bf * izz], -1))
        return rho, err, e["w"] * rw, torch.stack(JP, 1), torch.stack(JL, 1)

    def chi2(self, R, t, X) -> float:
        return float(sum(self._linearise(R, t, X, e, i == 1, False).to(torch.float64).sum()
                         for i, e in enumerate(self.edges)))

    def _normal_equations(self, R, t, X):
        dt, Pf, L = self.dtype, self.Pf, self.L
        Hpp = torch.zeros(Pf, 6, 6, dtype=dt, device=self.device)
        bp = torch.zeros(Pf, 6, dtype=dt, device=self.device)
        Hll = torch.zeros(L, 3, 3, dtype=dt, device=self.device)
        bl = torch.zeros(L, 3, dtype=dt, device=self.device)
        Hpl = torch.zeros(self.slot_l.numel(), 6, 3, dtype=dt, device=self.device)
        for i, e in enumerate(self.edges):
            if e["p"].numel() == 0:
                continue
            _, err, wt, JP, JL = self._linearise(R, t, X, e, i == 1, True)
            fp = e["fp"]
            m = fp >= 0
            Hpp.index_add_(0, fp[m], self.mm("e,eki,ekj->eij", wt[m], JP[m], JP[m]))
            bp.index_add_(0, fp[m], self.mm("e,eki,ek->ei", wt[m], JP[m], err[m]))
            Hll.index_add_(0, e["l"], self.mm("e,eki,ekj->eij", wt, JL, JL))
            bl.index_add_(0, e["l"], self.mm("e,eki,ek->ei", wt, JL, err))
            Hpl.index_add_(0, e["slot"][m], self.mm("e,eki,ekj->eij", wt[m], JP[m], JL[m]))
        return Hpp, bp, Hll, bl, Hpl

    def _solve(self, Hpp, bp, Hll, bl, Hpl, lam):
        """The damped step by the landmarks' Schur complement and a dense
        Cholesky factorisation: (xp [Pf, 6], xl [L, 3], ok)."""
        dt, Pf = self.dtype, self.Pf
        n = 6 * Pf
        eye3 = torch.eye(3, dtype=dt, device=self.device)
        Hll_inv = torch.linalg.inv(Hll + lam * eye3)
        W = self.mm("sij,sjk->sik", Hpl, Hll_inv[self.slot_l])
        S = torch.zeros(n * n, dtype=dt, device=self.device)
        blocks = torch.arange(Pf, device=self.device)
        rc = (torch.arange(6, device=self.device)[:, None] * n
              + torch.arange(6, device=self.device)[None, :]).reshape(36)
        diag = Hpp + lam * torch.eye(6, dtype=dt, device=self.device)
        S.index_add_(0, ((6 * blocks * n + 6 * blocks)[:, None] + rc).reshape(-1),
                     diag.reshape(-1))
        for a in range(0, self.pair_s.numel(), PAIR_CHUNK):
            s, u = self.pair_s[a:a + PAIR_CHUNK], self.pair_t[a:a + PAIR_CHUNK]
            prod = self.mm("cik,cjk->cij", W[s], Hpl[u])
            idx = ((6 * self.slot_p[s] * n + 6 * self.slot_p[u])[:, None] + rc).reshape(-1)
            S.index_add_(0, idx, -prod.reshape(-1))
        rhs = bp.clone()
        rhs.index_add_(0, self.slot_p, -self.mm("sij,sj->si", W, bl[self.slot_l]))
        Lc, info = torch.linalg.cholesky_ex(S.view(n, n))
        xp = torch.cholesky_solve(rhs.reshape(n, 1), Lc).reshape(Pf, 6)
        r = bl.clone()
        r.index_add_(0, self.slot_l, -self.mm("sji,sj->si", Hpl, xp[self.slot_p]))
        xl = self.mm("lij,lj->li", Hll_inv, r)
        ok = (info == 0) and bool(torch.isfinite(xp).all()) and bool(torch.isfinite(xl).all())
        return xp, xl, ok

    def _update(self, R, t, X, xp, xl):
        twist = torch.zeros(self.Pf, 4, 4, dtype=self.dtype, device=self.device)
        w, u = xp[:, :3], xp[:, 3:]
        twist[:, 0, 1], twist[:, 0, 2], twist[:, 1, 2] = -w[:, 2], w[:, 1], -w[:, 0]
        twist[:, 1, 0], twist[:, 2, 0], twist[:, 2, 1] = w[:, 2], -w[:, 1], w[:, 0]
        twist[:, :3, 3] = u
        T = torch.linalg.matrix_exp(twist)
        ids = self.free_ids
        R2, t2 = R.clone(), t.clone()
        R2[ids] = self.mm("pij,pjk->pik", T[:, :3, :3], R[ids])
        t2[ids] = self.mm("pij,pj->pi", T[:, :3, :3], t[ids]) + T[:, :3, 3]
        return R2, t2, X + xl

    # -- the LM loop ----------------------------------------------------------

    def optimize(self, niterations: int):
        """(chi² after each outer iteration, (R, t, X) at the end)."""
        lm = self.lm
        R, t, X = self.R0, self.t0, self.X0
        F = self.chi2(R, t, X)
        lam, nu = 0.0, 2.0
        chis: List[float] = []
        for it in range(niterations):
            Hpp, bp, Hll, bl, Hpl = self._normal_equations(R, t, X)
            if it == 0:
                dmax = torch.cat([Hpp.diagonal(dim1=1, dim2=2).reshape(-1),
                                  Hll.diagonal(dim1=1, dim2=2).reshape(-1)]).max()
                lam = lm.tau * max(float(dmax), 0.0)
            q = 0
            while True:
                xp, xl, ok = self._solve(Hpp, bp, Hll, bl, Hpl, lam)
                R2, t2, X2 = self._update(R, t, X, xp, xl)
                Fhat = self.chi2(R2, t2, X2)
                scale = float((xp * (lam * xp + bp)).sum() + (xl * (lam * xl + bl)).sum())
                scale += lm.scale_eps
                rho = (F - Fhat) / scale if ok else -1.0
                if rho > 0:
                    a = 1.0 - (2.0 * rho - 1.0) ** 3
                    lam *= min(max(a, lm.attenuation_min), lm.attenuation_max)
                    nu = 2.0
                    R, t, X, F = R2, t2, X2, Fhat
                else:
                    lam *= nu if ok else max(nu, lm.escalation)
                    nu *= 2.0
                q += 1
                if not (q < lm.max_inner and rho < 0):
                    break
            chis.append(F)
            if q == lm.max_inner or rho <= 0 or not np.isfinite(lam):
                break
        return np.array(chis), (R, t, X)
