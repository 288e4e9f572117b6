"""Block-solver engine: the Levenberg-Marquardt loop over every reduced
solver and both of ``cuba_tpu``'s front ends (port of
``cuba_tpu/solver/engine.py``).

Where the rows planner takes the structure (``rows.plan_rows``: poses,
landmarks and Hpl slots, and a ``schur_fused`` chunk plan that holds), the
engine runs the rows front end (``solver/rows.py``) and the matrix-free
PCG, the band (cyclic-reduction), the band + Woodbury loop-closure or the
dense (Cholesky) reduced solve on the v2 or the v1 Schur formation.
Elsewhere (pose-only and landmark-only problems, no Hpl slot, a chunk plan
that fails) it runs the AoS path (``solver/assembly.py``, ``schur.py``,
``pcg.py``) with the same four solvers, or the diagonal pose-only and
landmark-only solves.  The route is the planner's decision, never a
fallback from a kernel that failed.

The loop runs eagerly in torch.  Accept/reject is a ``torch.where`` on the
device; the host reads the device once per damped attempt (the gain ratio
and whether lambda is finite, which decide whether to retry or stop), once
per CG step and once per CG solve (the PCG stop test), once per fp32 band
factorisation or once per fp32 dense boost-retry decision (at most four per
attempt), plus once per ``optimize`` for the chi² trajectory.  The control
law is ``cuba_tpu``'s (``_make_lm_run``): lambda0 = tau * max diag,
attenuation clamped to [1/3, 2/3], nu doubling, x8 escalation when the
solve fails, and the accepted trial's residual packs carried into the next
build.  Given a :class:`PhaseMarks`, ``optimize`` marks the boundaries of
its five loop phases as it goes; under ``torch.profiler`` the same
boundaries open and close the phases' spans (``trace.py``), and each host
read has a span of its own.  ``optimize_profiled`` is ``cuba_tpu``'s
host-stepped driver with its own control law and exact per-phase timing.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from cuba_tpu_torch import trace
from cuba_tpu_torch.config import BAConfig
from cuba_tpu_torch.ops import se3, smallmat
from cuba_tpu_torch.solver import (assembly, band_cr, comm, dense_cholesky, edgerows, pcg,
                                   rows, schur, trisolve)
from cuba_tpu_torch.solver.structure import BAStructure

# "auto" takes the dense solver up to this many padded pose blocks
# (cuba_tpu engine._DENSE_MAX_PB)
_DENSE_MAX_PB = 4096
_SOLVERS = ("pcg", "band_cr", "band_lr", "dense_cholesky")

# the reference's 8-phase TimeProfile (cuba_tpu engine.PROFILE_ITEMS)
PROFILE_ITEMS = (
    "0: Initialize Optimizer",
    "1: Build Structure",
    "2: Compute Error",
    "3: Build System",
    "4: Schur Complement",
    "5: Symbolic Decomposition",
    "6: Numerical Decomposition",
    "7: Update Solution",
)
# the five phases of the LM loop; "5: Symbolic Decomposition" stays 0 (no
# solver here has a symbolic pass of its own at optimize time)
LOOP_PHASES = tuple(PROFILE_ITEMS[i] for i in (2, 3, 4, 6, 7))
_ERROR, _BUILD, _SCHUR, _DECOMP, _UPDATE = LOOP_PHASES
# the phases' spans (trace.span)
_SPANS = dict(zip(LOOP_PHASES, ("lm.error", "lm.build", "lm.schur", "lm.decomp", "lm.update")))


class State(NamedTuple):
    qs: torch.Tensor  # [total_p, 4]
    ts: torch.Tensor  # [total_p, 3]
    Xws: torch.Tensor  # [total_l, 3]


class LMResult(NamedTuple):
    state: State
    chis: np.ndarray  # [niters] F after each outer iteration (chi_dtype)
    niters: int  # outer iterations run
    nattempts: int  # damped solves (inner trials)
    cg_steps: int  # CG steps over all attempts (0 on the band path)
    host_reads: int  # device-to-host reads the loop made
    final_lambda: float  # the damping at exit, in the compute dtype


def _no_phase(_phase) -> None:
    pass


class PhaseMarks:
    """The phase boundaries of one ``optimize``: each :meth:`mark` closes
    the span since the previous one and charges it to a phase of
    :data:`LOOP_PHASES` (or to none).  On the card a mark is a CUDA event
    recorded on the current stream, with no synchronisation; on the CPU,
    where torch runs synchronously, the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []
        self.mark(None)

    def mark(self, phase: Optional[str]) -> None:
        if self.cuda:
            t = torch.cuda.Event(enable_timing=True)
            t.record()
        else:
            t = time.perf_counter()
        self.marks.append((phase, t))

    def seconds(self) -> dict:
        """{phase: seconds} over :data:`LOOP_PHASES`; waits for the last
        event on the card."""
        out = dict.fromkeys(LOOP_PHASES, 0.0)
        if self.cuda:
            self.marks[-1][1].synchronize()
        for (_, a), (phase, b) in zip(self.marks, self.marks[1:]):
            if phase is not None:
                out[phase] += a.elapsed_time(b) / 1e3 if self.cuda else b - a
        return out


class _Phases:
    """The phase boundaries of one ``optimize``, each made once: a
    :meth:`begin` ends the phase open since the previous boundary and opens
    ``phase``'s span (``lm.*``; None opens none).  With ``marks``, the same
    call charges the closed interval to the phase that was open
    (:meth:`PhaseMarks.mark`), so the spans and the phase marks share one
    set of boundaries.  The first phase opens at construction, after the
    marks' first boundary (their construction)."""

    __slots__ = ("_mark", "_open", "_span")

    def __init__(self, first: str, marks: Optional[PhaseMarks] = None):
        self._mark = None if marks is None else marks.mark
        self._span = None
        self._enter(first)

    def _enter(self, phase: Optional[str]) -> None:
        self._open = phase
        if phase is not None:
            self._span = trace.span(_SPANS[phase])
            self._span.__enter__()

    def begin(self, phase: Optional[str]) -> None:
        self.close()
        if self._mark is not None:
            self._mark(self._open)
        self._enter(phase)

    def close(self) -> None:
        """Leaves the open span, if any; marks nothing."""
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None


def _set_exact_fp32() -> None:
    """No TF32 anywhere: the analogue of the TPU's default bf16 matmul."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_solver(s: BAStructure, config: BAConfig):
    """Band certification and the solver choice, as cuba_tpu's engine makes
    them: (solver, band_m, pad_blocks, lr).  band_m is the CR block count of
    a pure band, else 0; lr is the host Woodbury plan
    (:func:`band_cr.loop_plan`) of a band with loop closures, else None."""
    pad_blocks = rows.pad_blocks_of(s.num_p, config.pose_block_pad)
    m_lr, ob_idx = band_cr.certify_lr(s.hsc_row, s.hsc_col, pad_blocks)
    band_m = m_lr if ob_idx.size == 0 else 0
    # banded plus at most 64 loop-closure pose-block columns
    lr = band_cr.loop_plan(s.hsc_row, s.hsc_col, m_lr, ob_idx)
    has_lr = lr is not None
    if config.solver == "band_cr" and not band_m:
        raise ValueError(
            "solver='band_cr' requires a band-certified Schur pattern "
            "(half-bandwidth <= 64 pose blocks after the locality "
            "reorder); this problem is not banded — use 'band_lr' "
            "(banded + loop closures), 'dense_cholesky' or 'pcg'"
        )
    if config.solver == "band_lr" and not has_lr and not band_m:
        raise ValueError(
            "solver='band_lr' requires a banded-plus-low-rank Schur "
            "pattern (in-band half-bandwidth <= 64 pose blocks and at "
            "most 64 loop-closure pose-block columns) — use "
            "'dense_cholesky' or 'pcg'"
        )
    solver = config.solver
    if solver == "auto":
        # CR's batched levels pay off from m >= 8; small systems factor
        # fastest dense
        if band_m >= 8:
            solver = "band_cr"
        elif has_lr and m_lr >= 8:
            solver = "band_lr"
        elif pad_blocks <= _DENSE_MAX_PB:
            solver = "dense_cholesky"
        else:
            solver = "pcg"
    if solver == "band_lr" and not has_lr:
        solver = "band_cr"  # a pure band after all
    return solver, band_m, pad_blocks, lr


def resolve_device(config: BAConfig) -> torch.device:
    """The config's device; raises for the card where there is none."""
    device = config.resolve_device()
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"BAConfig.device is {str(config.device)!r} (the default is the card) but "
            'torch.cuda.is_available() is False: pass BAConfig(device="cpu") to run '
            "on the host")
    return device


def check_solver(solver: str, config: BAConfig) -> None:
    if solver not in _SOLVERS:
        raise ValueError(f"unknown solver {config.solver!r}")


class BlockSolverEngine:
    """Owns the device tables of one problem structure and runs the LM loop.

    The loop (:meth:`optimize`, :meth:`optimize_profiled`) reads the
    problem only through the engine's steps: residuals and chi², build,
    max diagonal, solve, update and gain-ratio scale.  Each step calls
    :mod:`solver.comm` where ``cuba_tpu``'s sharded engine has a
    collective; with ``group`` None those calls are identities.
    ``parallel.sharding.MultiChipEngine`` runs the same loop over one
    landmark shard and its process group."""

    group = None  # the landmark shards' process group; None: one device

    def __init__(self, structure: BAStructure, kernels, config: BAConfig):
        with trace.span("engine"):
            device = resolve_device(config)
            with trace.span("engine.resolve"):
                solver, band_m, pad_blocks, lr = resolve_solver(structure, config)
            check_solver(solver, config)
            with trace.span("engine.plan_rows"):
                plan, rc = rows.plan_rows(
                    structure, device, config.dtype,
                    pad_blocks=0 if solver == "pcg" else pad_blocks,
                    dense=solver == "dense_cholesky", lr=lr)
            self._setup(structure, kernels, config, device, solver, band_m, pad_blocks, lr,
                        plan, rc)

    def _setup(self, s: BAStructure, kernels, config: BAConfig, device, solver, band_m,
               pad_blocks, lr, plan, rc) -> None:
        """The engine's tables: the rows front end's (``plan``, ``rc``, as
        ``rows.plan_rows`` made them for ``solver``) or, with no plan, the
        AoS path's."""
        self.device = device
        self.solver, self.band_m, self.pad_blocks = solver, band_m, pad_blocks
        self.structure = s
        self.config = config
        self.dtype = config.dtype
        self.chi_dtype = config.chi_dtype
        if self.device.type == "cuda":
            _set_exact_fp32()
        self.kernels = tuple((int(k[0]), float(k[1])) for k in kernels)
        self.num_p, self.num_l = s.num_p, s.num_l
        self.plan, self.rc = plan, rc
        # the rows front end where the planner takes the structure, else the AoS path
        self.use_rows = self.plan is not None
        # band_lr's host Woodbury plan and its loop columns (ob_i, ob_j,
        # jrows) on the device, for every formation
        self.lr = lr if self.solver == "band_lr" else None

        def dev(a, dtype=self.dtype):
            with trace.span("engine.upload"):
                return torch.as_tensor(a, dtype=dtype, device=self.device)

        self.lr_dev = None if self.lr is None else tuple(
            dev(self.lr[k], None) for k in ("ob_i", "ob_j", "jrows"))
        self.cams = dev(s.cams)
        self.state = State(dev(s.qs), dev(s.ts), dev(s.Xws))
        if not self.use_rows:
            Em = s.mono.count
            self.edges = tuple(
                assembly.edge_consts(e.measurements, e.omegas, e.pose_idx, e.lm_idx, e2h,
                                     s.num_p, s.num_l, s.n_hpl, self.device, self.dtype)
                if e.count else None
                for e, e2h in ((s.mono, s.edge2hpl[:Em]), (s.stereo, s.edge2hpl[Em:])))
            self.sc = schur.schur_consts(s, self.device) if s.num_p and s.num_l else None

    @property
    def path(self) -> str:
        """The route the planner chose: "v2" or "v1" (the rows front end
        with that Schur formation), "rows" (the rows front end with PCG) or
        "aos"."""
        if not self.use_rows:
            return "aos"
        if self.plan.schur is None:
            return "rows"
        return "v2" if self.plan.v2 else "v1"

    # -- building blocks -------------------------------------------------

    def _residuals_and_chi(self, state: State):
        """(pack_m, pack_s, chi): the rows front end's packs, or the AoS
        path's (err [E, mdim], Xc [E, 3]); None for an absent edge type.
        chi is all-reduced over the landmark shards."""
        s = self.structure
        if self.use_rows:
            pack_m, pack_s, chi = rows.edge_rows(
                state.qs, state.ts, state.Xws, self.cams, self.kernels, self.chi_dtype,
                (s.mono.count, s.stereo.count), self.rc,
            )
            return pack_m, pack_s, comm.all_reduce_sum(chi, self.group)
        chi = torch.zeros((), dtype=self.chi_dtype, device=self.device)
        packs = []
        for ec, mdim, kern in zip(self.edges, (2, 3), self.kernels):
            if ec is None:
                packs.append(None)
                continue
            err, Xc = assembly.edge_residuals(state.qs, state.ts, self.cams, state.Xws, ec,
                                              mdim)
            chi = chi + assembly.chi_sum(err, ec.omega, kern, self.chi_dtype)
            packs.append((err, Xc))
        return packs[0], packs[1], comm.all_reduce_sum(chi, self.group)

    def _build(self, pack_m, pack_s, state: Optional[State] = None):
        """The system: (HppT, HllT, HplT) on the rows front end, (Hpp, bp,
        Hll, bl, Hpl) on the AoS path, whose Jacobians also read the poses
        of ``state``, the state the packs were computed at.  The pose rows
        (HppT; Hpp and bp) are all-reduced over the landmark shards."""
        if self.use_rows:
            HppT, HllT, HplT = rows.build_system_rows(pack_m, pack_s, self.kernels,
                                                      self.num_p, self.num_l, self.plan,
                                                      self.rc)
            return comm.all_reduce_sum(HppT, self.group), HllT, HplT
        edges = tuple(None if pack is None else (ec, pack[0], pack[1], mdim)
                      for ec, pack, mdim in zip(self.edges, (pack_m, pack_s), (2, 3)))
        Hpp, bp, Hll, bl, Hpl = assembly.build_system(state.qs, self.cams, self.num_p,
                                                      self.num_l, self.structure.n_hpl,
                                                      edges, self.kernels)
        if self.group is not None and self.num_p:
            P = self.num_p
            p42 = comm.all_reduce_sum(torch.cat([Hpp.reshape(P, 36), bp], 1), self.group)
            Hpp, bp = p42[:, :36].reshape(P, 6, 6), p42[:, 36:]
        return Hpp, bp, Hll, bl, Hpl

    def _refine(self) -> int:
        return self.config.refinement_steps if self.dtype == torch.float32 else 0

    def _reduced_rhs(self, bsc: torch.Tensor) -> torch.Tensor:
        """The padded right-hand side [6PB] from bsc [P, 6]."""
        rhs = bsc.new_zeros(6 * self.pad_blocks)
        rhs[:6 * self.num_p] = bsc.reshape(-1)
        return rhs

    def _woodbury(self, Dm, rhs, refine):
        """band_lr over a dense Schur matrix: its band, its out-of-band
        blocks and the host Woodbury plan; at least one refinement sweep,
        which recovers what the Gershgorin shift costs in conditioning."""
        D, U = band_cr.from_dense(Dm, self.lr["m"])
        Vob = band_cr.ob_from_dense(Dm, self.lr["obr"], self.lr["obc"])
        return band_cr.cr_solve_woodbury(D, U, rhs, Vob, *self.lr_dev, max(refine, 1))

    @property
    def _solve_phase(self) -> str:
        """The phase a trial solve opens with: the Schur complement's, or
        the decomposition's where there is none (pose-only and
        landmark-only problems)."""
        return _SCHUR if self.use_rows or (self.num_p and self.num_l) else _DECOMP

    def _pcg_reads(self, k: int) -> int:
        """The stop test's host reads of a PCG solve of ``k`` steps: one a
        step, and the one that stopped it unless it ran out of steps."""
        return k + (k < self.config.pcg_max_iterations)

    def _solve(self, sys, lam, begin=_no_phase):
        """One damped trial solve.  Returns (xp [P, 6], xl [L, 3], ok,
        cg_steps, host_reads).  ``begin`` (:meth:`_Phases.begin`) opens the
        decomposition's phase (the reduced solve and the back-substitution)
        after the Schur complement's (the factors and the formation), then
        the update's."""
        if not self.use_rows:
            return self._solve_aos(sys, lam, begin)
        HppT, HllT, HplT = sys
        plan, rc, P = self.plan, self.rc, self.num_p
        iv9, W, bscT, g12 = rows.prepare_factors(HppT, HllT, HplT, lam, P, rc, group=self.group)
        if self.solver == "pcg":
            begin(_DECOMP)
            xT, ok, k = rows.pcg_solve_rows(
                HppT, HplT, W, lam, bscT, P, self.num_l, rc, self.config.pcg_max_iterations,
                self.config.pcg_tol, group=self.group,
            )
            xp, reads = xT.T, self._pcg_reads(k)
        else:
            rhs = self._reduced_rhs(bscT.T)
            refine = self._refine()
            if self.solver == "band_cr":
                if plan.v2:
                    D, U = rows.band_from_compact(self._schur_table(W, HplT), HppT, lam, P,
                                                  plan, rc)
                else:
                    D, U = band_cr.from_dense(rows.schur_dense(HppT, W, HplT, lam, P, plan, rc),
                                              self.band_m)
                begin(_DECOMP)
                x, ok, reads = band_cr.cr_solve(D, U, rhs, refine)
            elif self.solver == "band_lr":
                if plan.v2:
                    D, U, Vob = rows.band_from_compact(self._schur_table(W, HplT), HppT, lam,
                                                       P, plan, rc, with_ob=True)
                    begin(_DECOMP)
                    x, ok, reads = band_cr.cr_solve_woodbury(D, U, rhs, Vob, *self.lr_dev,
                                                             max(refine, 1))
                else:
                    Dm = rows.schur_dense(HppT, W, HplT, lam, P, plan, rc)
                    begin(_DECOMP)
                    x, ok, reads = self._woodbury(Dm, rhs, refine)
            else:
                if plan.v2:
                    Dm = rows.dense_from_compact(self._schur_table(W, HplT), HppT, lam, P,
                                                 plan, rc)
                else:
                    Dm = rows.schur_dense_v1(HppT, W, HplT, lam, P, plan, rc)
                begin(_DECOMP)
                # the blocked trisolve kernels on the card (cuba_tpu takes
                # them on the TPU), with one extra refinement sweep for the
                # inverted-diagonal-block substitution's larger residual, as
                # cuba_tpu does; elsewhere solve_triangular and A @ v
                use_ts = self.device.type == "cuda" and trisolve.usable(rhs.shape[0], self.dtype)
                if use_ts and refine > 0:
                    refine += 1
                x, ok, reads = dense_cholesky.cholesky_solve(Dm, rhs, refine,
                                                             use_kernels=use_ts)
            xp, k = x[:6 * P].reshape(P, 6), 0
        xl = rows.back_substitute(iv9, HllT, HplT, g12, xp, self.num_l, rc)
        begin(_UPDATE)
        return xp, xl, ok, k, reads

    def _schur_table(self, W, HplT):
        """The v2 compact Schur table gT, all-reduced over the landmark
        shards."""
        return comm.all_reduce_sum(rows.schur_compact(W, HplT, self.plan, self.rc),
                                   self.group)

    def _schur_operator(self, Hpp_d, Hpl, W):
        """The AoS path's matrix-free Schur operator."""
        return pcg.SchurOperator(Hpp_d, Hpl, W, self.sc, self.num_p, self.num_l)

    def _solve_aos(self, sys, lam, begin=_no_phase):
        """The AoS path's trial solve (cuba_tpu's non-MXU branch): the Schur
        reduction with any of the four solvers, or the diagonal pose-only
        or landmark-only solve (all of it the decomposition's phase)."""
        Hpp, bp, Hll, bl, Hpl = sys
        P, L, dt = self.num_p, self.num_l, self.dtype
        if P and L:
            Hpp_d = assembly.damp(Hpp, lam)
            invHll, W, bsc = schur.prepare_factors(bp, assembly.damp(Hll, lam), bl, Hpl,
                                                   self.sc, P, group=self.group)
            k = 0
            if self.solver == "pcg":
                begin(_DECOMP)
                xp, ok, k = pcg.pcg_solve(self._schur_operator(Hpp_d, Hpl, W), bsc,
                                          self.config.pcg_max_iterations,
                                          self.config.pcg_tol)
                reads = self._pcg_reads(k)
            else:
                blocks = comm.all_reduce_sum(schur.schur_blocks(W, Hpl, self.sc), self.group)
                Dm = schur.dense_from_blocks(Hpp_d, blocks, self.sc, P, self.pad_blocks)
                begin(_DECOMP)
                rhs = self._reduced_rhs(bsc)
                refine = self._refine()
                if self.solver == "band_cr":
                    D, U = band_cr.from_dense(Dm, self.band_m)
                    x, ok, reads = band_cr.cr_solve(D, U, rhs, refine)
                elif self.solver == "band_lr":
                    x, ok, reads = self._woodbury(Dm, rhs, refine)
                else:
                    x, ok, reads = dense_cholesky.cholesky_solve(Dm, rhs, refine)
                xp = x[:6 * P].reshape(P, 6)
            xl = schur.back_substitute(invHll, bl, Hpl, xp, self.sc, L)
            begin(_UPDATE)
            return xp, xl, ok, k, reads
        if P:
            xp = smallmat.solve_sym6x6(assembly.damp(Hpp, lam), bp)
            begin(_UPDATE)
            return xp, bp.new_zeros((0, 3)), torch.isfinite(xp).all(), 0, 0
        xl = smallmat.solve_sym3x3(assembly.damp(Hll, lam), bl)
        begin(_UPDATE)
        ok = comm.all_reduce_min(torch.isfinite(xl).all(), self.group)
        return bl.new_zeros((0, 6)), xl, ok, 0, 0

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

    def _rhs_of(self, sys):
        """(bp [P, 6], bl [L, 3])."""
        if not self.use_rows:
            return sys[1], sys[3]
        HppT, HllT, _ = sys
        return HppT[36:42].T, HllT[9:12].T

    def _max_diag(self, sys):
        """Max over the block-diagonal entries, floored at 0, and over the
        landmark shards."""
        if self.use_rows:
            m = rows.max_diagonal_T(sys[0], sys[1])
        else:
            m = assembly.max_diagonal(sys[0], sys[2])
        return comm.all_reduce_max(m, self.group)

    def _scale(self, xp, xl, bp, bl, lam):
        """Gain-ratio denominator sum x * (lambda x + b); the landmark part
        all-reduced over the landmark shards."""
        return (xp * (lam * xp + bp)).sum() + comm.all_reduce_sum((xl * (lam * xl + bl)).sum(),
                                                                  self.group)

    # -- the LM loop -----------------------------------------------------

    def optimize(self, state: State, niterations: int,
                 marks: Optional[PhaseMarks] = None) -> LMResult:
        """The LM loop, in the span ``optimize``, with the span of each of
        its phases (``lm.*``) and of each host read (``read.*``); with
        ``marks``, the boundaries of its phases (as ``cuba_tpu``'s
        ``attribute_phases`` draws them: both residual passes; the build
        with its right-hand side and the first damping; the factors and the
        Schur formation; the reduced solve and the back-substitution; the
        update and the accept selects)."""
        with trace.span("optimize"):
            phases = _Phases(_ERROR, marks)
            try:
                return self._lm(self.state if state is None else state, niterations,
                                phases.begin)
            finally:
                phases.close()

    def _lm(self, st: State, niterations: int, begin) -> LMResult:
        """:meth:`optimize`'s loop from ``st``, the error phase open;
        ``begin`` (:meth:`_Phases.begin`) makes each phase boundary."""
        cfg, dt = self.config, self.dtype
        maxq = cfg.max_inner_iterations

        def attenuation(rho):
            a = 1.0 - (2.0 * rho - 1.0) ** 3
            return torch.clamp(a, cfg.attenuation_min, cfg.attenuation_max)

        pack_m, pack_s, F0 = self._residuals_and_chi(st)
        F = F0.to(dt)
        begin(_BUILD)
        lam = torch.zeros((), dtype=dt, device=self.device)
        nu = torch.full((), 2.0, dtype=dt, device=self.device)
        minus_one = torch.full((), -1.0, dtype=dt, device=self.device)
        chis = []
        natt = cg = reads = 0
        for it in range(niterations):
            sys = self._build(pack_m, pack_s, st)
            bp, bl = self._rhs_of(sys)
            if it == 0:
                lam = cfg.tau * self._max_diag(sys).to(dt)
            begin(self._solve_phase)
            q = 0
            while True:
                xp, xl, ok, k, solve_reads = self._solve(sys, lam, begin)
                cg += k
                reads += solve_reads
                trial = self._apply_update(st, xp, xl)
                begin(_ERROR)
                tm, ts_, F0t = self._residuals_and_chi(trial)
                Fhat = F0t.to(dt)
                begin(_UPDATE)
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
                begin(None)
                q += 1
                with trace.span("read.accept"):
                    rho_h, lam_finite = torch.stack(
                        [rho, torch.isfinite(lam).to(dt)]).tolist()
                reads += 1
                retry = q < maxq and rho_h < 0
                stop = not retry and (q == maxq or rho_h <= 0 or not lam_finite)
                # the next phase: another attempt's, the next build, or none
                if retry:
                    begin(self._solve_phase)
                else:
                    begin(None if stop or it + 1 == niterations else _BUILD)
                    break
            natt += q
            chis.append(F.to(self.chi_dtype))
            if stop:
                break
        # the trajectory and the final damping, the card idle after the first
        with trace.span("read.chis"):
            chis_h = torch.stack(chis).cpu().numpy() if chis else np.zeros(0)
            final_lambda = float(lam)
        reads += 1
        return LMResult(state=st, chis=chis_h, niters=len(chis), nattempts=natt,
                        cg_steps=cg, host_reads=reads, final_lambda=final_lambda)

    def optimize_profiled(self, state: State, niterations: int):
        """``cuba_tpu``'s host-stepped LM driver with per-phase timers
        (``engine.optimize_profiled``): each phase ends in a synchronisation
        of the card before the host clock is read.  Returns (LMResult,
        {PROFILE_ITEMS key: seconds}).

        Its control law is that driver's, not :meth:`optimize`'s: a failed
        or rejected attempt multiplies lambda by nu (no
        ``numerical_escalation``), the accepted attempt does not count in q,
        and the residuals are recomputed at the top of every outer
        iteration.  The whole trial solve, Schur formation included, is
        charged to "6: Numerical Decomposition", so "4: Schur Complement"
        and "5: Symbolic Decomposition" stay 0."""
        cfg, dt = self.config, self.dtype
        st = self.state if state is None else state
        prof = dict.fromkeys(PROFILE_ITEMS, 0.0)
        cuda = self.device.type == "cuda"

        def tick():
            if cuda:
                torch.cuda.synchronize()
            return time.perf_counter()

        def lam_dev(lam):
            return torch.tensor(lam, dtype=dt, device=self.device)

        chis = []
        lam, nu = 0.0, 2.0
        natt = cg = reads = 0
        for it in range(niterations):
            t0 = tick()
            pack_m, pack_s, F_dev = self._residuals_and_chi(st)
            F = float(F_dev)
            reads += 1
            prof[_ERROR] += tick() - t0

            t0 = tick()
            sys = self._build(pack_m, pack_s, st)
            bp, bl = self._rhs_of(sys)
            prof[_BUILD] += tick() - t0

            if it == 0:
                lam = cfg.tau * float(self._max_diag(sys))
                reads += 1

            q, rho = 0, -1.0
            while q < cfg.max_inner_iterations and rho < 0:
                t0 = tick()
                xp, xl, ok, k, solve_reads = self._solve(sys, lam_dev(lam))
                cg += k
                reads += solve_reads
                prof[_DECOMP] += tick() - t0

                t0 = tick()
                trial = self._apply_update(st, xp, xl)
                prof[_UPDATE] += tick() - t0

                t0 = tick()
                Fhat = float(self._residuals_and_chi(trial)[2])
                prof[_ERROR] += tick() - t0

                scale = float(self._scale(xp, xl, bp, bl, lam_dev(lam))) + cfg.scale_eps
                rho = (F - Fhat) / scale if bool(ok) else -1.0
                reads += 3
                natt += 1
                if rho > 0:
                    a = 1.0 - (2.0 * rho - 1.0) ** 3
                    lam *= float(np.clip(a, cfg.attenuation_min, cfg.attenuation_max))
                    nu = 2.0
                    F = Fhat
                    st = trial
                    break
                lam *= nu
                nu *= 2.0
                q += 1

            chis.append(F)
            if q == cfg.max_inner_iterations or rho <= 0 or not np.isfinite(lam):
                break
        result = LMResult(state=st, chis=np.array(chis), niters=len(chis), nattempts=natt,
                          cg_steps=cg, host_reads=reads,
                          final_lambda=float(lam_dev(lam)))
        return result, prof

    def chi_squares(self, state: State) -> np.ndarray:
        """Per-edge unrobustified chi² in the caller's edge insertion order
        (mono then stereo; the internal edge sort is undone)."""
        s = self.structure
        pack_m, pack_s, _ = self._residuals_and_chi(state)
        out = []
        for i, (pack, count, perm) in enumerate(((pack_m, s.mono.count, s.mono_perm),
                                                 (pack_s, s.stereo.count, s.stereo_perm))):
            if pack is None:
                continue
            if self.use_rows:
                omegaT = (self.rc.omegaT_m, self.rc.omegaT_s)[i]
                chis = edgerows.chi_per_edge(pack[1], omegaT)[:count]
            else:
                chis = assembly.chi_squares(pack[0], self.edges[i].omega)
            internal = chis.cpu().numpy()
            original = np.empty_like(internal)
            original[perm] = internal
            out.append(original)
        return np.concatenate(out) if out else np.zeros(0)
