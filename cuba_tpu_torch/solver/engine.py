"""Block-solver engine: the Levenberg-Marquardt loop over the rows front end
and the matrix-free PCG reduced solve (port of the PCG path of
``cuba_tpu/solver/engine.py``).

The loop runs eagerly in torch.  Accept/reject is a ``torch.where`` on the
device; the host reads the device once per damped attempt (the gain ratio
and whether lambda is finite, which decide whether to retry or stop) and
once per CG step (the PCG stop test), plus once per ``optimize`` for the
chi² trajectory.  The control law is ``cuba_tpu``'s (``_make_lm_run``):
lambda0 = tau * max diag, attenuation clamped to [1/3, 2/3], nu doubling,
x8 escalation when the solve fails, and the accepted trial's residual packs
carried into the next build.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cuba_tpu_torch.config import BAConfig
from cuba_tpu_torch.ops import se3
from cuba_tpu_torch.solver import edgerows, rows
from cuba_tpu_torch.solver.structure import BAStructure


class State(NamedTuple):
    qs: torch.Tensor  # [total_p, 4]
    ts: torch.Tensor  # [total_p, 3]
    Xws: torch.Tensor  # [total_l, 3]


class LMResult(NamedTuple):
    state: State
    chis: np.ndarray  # [niters] F after each outer iteration (chi_dtype)
    niters: int  # outer iterations run
    nattempts: int  # damped solves (inner trials)
    cg_steps: int  # CG steps over all attempts
    host_reads: int  # device-to-host reads the loop made


def _set_exact_fp32() -> None:
    """No TF32 anywhere: the analogue of the TPU's default bf16 matmul."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class BlockSolverEngine:
    """Owns the device tables of one problem structure and runs the LM loop."""

    def __init__(self, structure: BAStructure, kernels, config: BAConfig):
        if config.solver != "pcg":
            raise NotImplementedError(
                f"solver={config.solver!r}: only 'pcg' is ported; the band, "
                "band+Woodbury and dense solvers (and 'auto', which picks among "
                "them) are ROADMAP queue 1 items 'Band solver', "
                "'Loop-closure solver' and 'Dense solver'"
            )
        self.structure = s = structure
        self.config = config
        self.device = config.resolve_device()
        self.dtype = config.dtype
        self.chi_dtype = config.chi_dtype
        if self.device.type == "cuda":
            if self.dtype != torch.float32:
                raise NotImplementedError(
                    "the CUDA kernels are fp32 only; fp64 kernels are a ROADMAP item"
                )
            _set_exact_fp32()
        self.kernels = tuple((int(k[0]), float(k[1])) for k in kernels)
        self.num_p, self.num_l = s.num_p, s.num_l
        self.plan, self.rc = rows.plan_rows(s, self.device, self.dtype)

        def dev(a):
            return torch.as_tensor(a, dtype=self.dtype, device=self.device)

        self.cams = dev(s.cams)
        self.state = State(dev(s.qs), dev(s.ts), dev(s.Xws))

    # -- building blocks -------------------------------------------------

    def _residuals_and_chi(self, state: State):
        """(pack_m, pack_s, chi) of the rows front end."""
        s = self.structure
        return rows.edge_rows(
            state.qs, state.ts, state.Xws, self.cams, self.kernels, self.chi_dtype,
            (s.mono.count, s.stereo.count), self.plan, self.rc,
        )

    def _build(self, pack_m, pack_s):
        return rows.build_system_rows(pack_m, pack_s, self.kernels, self.num_p,
                                      self.num_l, self.plan, self.rc)

    def _solve(self, sys, lam):
        """One damped trial solve.  Returns (xp [P, 6], xl [L, 3], ok, cg_steps)."""
        HppT, HllT, HplT = sys
        plan, rc = self.plan, self.rc
        iv9, W, bscT, g12 = rows.prepare_factors(HppT, HllT, HplT, lam, self.num_p,
                                                 self.num_l, plan, rc)
        xT, ok, k = rows.pcg_solve_rows(
            HppT, HplT, W, lam, bscT, self.num_p, self.num_l, plan, rc,
            self.config.pcg_max_iterations, self.config.pcg_tol,
        )
        xp = xT.T
        xl = rows.back_substitute(iv9, HllT, HplT, g12, xp, self.num_l, plan, rc)
        return xp, xl, ok, k

    def _apply_update(self, state: State, xp, xl) -> State:
        """Left-compose the pose steps and add the landmark steps (active
        vertices only)."""
        P, L = self.num_p, self.num_l
        qn, tn = se3.update_pose(xp, state.qs[:P], state.ts[:P])
        return State(
            torch.cat([qn, state.qs[P:]]),
            torch.cat([tn, state.ts[P:]]),
            torch.cat([state.Xws[:L] + xl, state.Xws[L:]]),
        )

    @staticmethod
    def _rhs_of(sys):
        """(bp [P, 6], bl [L, 3])."""
        HppT, HllT, _ = sys
        return HppT[36:42].T, HllT[9:12].T

    @staticmethod
    def _scale(xp, xl, bp, bl, lam):
        """Gain-ratio denominator sum x * (lambda x + b)."""
        return (xp * (lam * xp + bp)).sum() + (xl * (lam * xl + bl)).sum()

    # -- the LM loop -----------------------------------------------------

    def optimize(self, state: State, niterations: int) -> LMResult:
        cfg, dt = self.config, self.dtype
        maxq = cfg.max_inner_iterations
        st = self.state if state is None else state

        def attenuation(rho):
            a = 1.0 - (2.0 * rho - 1.0) ** 3
            return torch.clamp(a, cfg.attenuation_min, cfg.attenuation_max)

        pack_m, pack_s, F0 = self._residuals_and_chi(st)
        F = F0.to(dt)
        lam = torch.zeros((), dtype=dt, device=self.device)
        nu = torch.full((), 2.0, dtype=dt, device=self.device)
        minus_one = torch.full((), -1.0, dtype=dt, device=self.device)
        chis = []
        natt = cg = reads = 0
        for it in range(niterations):
            sys = self._build(pack_m, pack_s)
            bp, bl = self._rhs_of(sys)
            if it == 0:
                lam = cfg.tau * rows.max_diagonal_T(sys[0], sys[1]).to(dt)
            q = 0
            while True:
                xp, xl, ok, k = self._solve(sys, lam)
                cg += k
                reads += k + 1
                trial = self._apply_update(st, xp, xl)
                tm, ts_, F0t = self._residuals_and_chi(trial)
                Fhat = F0t.to(dt)
                scale = self._scale(xp, xl, bp, bl, lam) + cfg.scale_eps
                rho = torch.where(ok, (F - Fhat) / scale, minus_one)
                accept = rho > 0
                # a failed solve marks the fp32 precision floor, not a trust
                # region signal: escalate lambda faster than nu doubling
                esc = torch.where(ok, nu, torch.clamp(nu, min=cfg.numerical_escalation))
                lam = torch.where(accept, lam * attenuation(rho), lam * esc)
                nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
                st = State(*(torch.where(accept, a, b) for a, b in zip(trial, st)))
                pack_m = None if pack_m is None else tuple(
                    torch.where(accept, a, b) for a, b in zip(tm, pack_m))
                pack_s = None if pack_s is None else tuple(
                    torch.where(accept, a, b) for a, b in zip(ts_, pack_s))
                F = torch.where(accept, Fhat, F)
                q += 1
                rho_h, lam_finite = torch.stack(
                    [rho, torch.isfinite(lam).to(dt)]).tolist()
                reads += 1
                if not (q < maxq and rho_h < 0):
                    break
            natt += q
            chis.append(F.to(self.chi_dtype))
            if q == maxq or rho_h <= 0 or not lam_finite:
                break
        chis_h = torch.stack(chis).cpu().numpy() if chis else np.zeros(0)
        reads += 1
        return LMResult(state=st, chis=chis_h, niters=len(chis), nattempts=natt,
                        cg_steps=cg, host_reads=reads)

    def chi_squares(self, state: State) -> np.ndarray:
        """Per-edge unrobustified chi² in the caller's edge insertion order
        (mono then stereo; the internal edge sort is undone)."""
        s = self.structure
        pack_m, pack_s, _ = self._residuals_and_chi(state)
        out = []
        for pack, omegaT, count, perm in (
            (pack_m, self.rc.omegaT_m, s.mono.count, s.mono_perm),
            (pack_s, self.rc.omegaT_s, s.stereo.count, s.stereo_perm),
        ):
            if pack is None:
                continue
            internal = edgerows.chi_per_edge(pack[1], omegaT)[:count].cpu().numpy()
            original = np.empty_like(internal)
            original[perm] = internal
            out.append(original)
        return np.concatenate(out) if out else np.zeros(0)
