"""Landmark-sharded multi-device bundle adjustment over a ``torch.distributed``
process group (port of ``cuba_tpu/parallel/sharding.py``).

``cuba_tpu`` runs one SPMD program inside one process: ``shard_map`` over a
``"landmarks"`` mesh axis, ``psum``/``pmax`` as its collectives.  The port
is SPMD by process, as torch users run it (``torchrun``, ``mp.spawn``):
every rank builds the same graph and calls the same API; rank r owns shard
r.  Poses are replicated; landmarks, their edges, Hpl slots and Schur
triplets are shard-local:

  per shard:   residuals and the chi² part, the Hpp/bp contributions, the
               owned Hll/bl and Hpl slots, W = Hpl Hll^-1, the shard's
               triplets summed into the global Schur table
  collectives: chi², Hpp and bp, the W bl pose sum, the Schur table (the
               compact gT [36, M*Wg] on the rows route, the sparse block
               table [n_hsc, 6, 6] on the AoS route) and the gain ratio's
               landmark part are all-reduced, lambda0's max diagonal
               max-reduced; the PCG matvec's and preconditioner's pose sums
               are all-reduced per CG step (:mod:`solver.comm`)
  replicated:  the band or dense formation and solve of the reduced
               system, lambda control, the pose update: the same bits on
               every rank, since every input is an all-reduce's result
  local:       back-substitution and the landmark update

The LM loop is ``BlockSolverEngine``'s, one control law for both engines:
:class:`MultiChipEngine` is that engine over this rank's shard
(:func:`rows_shard.cut_shards`), with the process group set.  Each rank
plans its shard with the rows front end (:mod:`parallel.rows_shard`);
where any shard's plan fails (or lacks the v2 tables) every rank takes the
AoS body instead, ``cuba_tpu``'s XLA body, on the same shard.  Its segment
sums are the AoS path's CSR kernel.  ``cuba_tpu``'s XLA body runs on
padded tables of its own (``shard_problem``), which its static shapes
need; a process a rank needs none, so the port has one cut for both
routes.  A shard's padding landmarks have no edges: their damped block is
lambda I and their step exactly 0, on both routes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from cuba_tpu_torch import trace
from cuba_tpu_torch.config import BAConfig
from cuba_tpu_torch.parallel import rows_shard
from cuba_tpu_torch.solver import assembly, comm, engine, pcg
from cuba_tpu_torch.solver.engine import LMResult, State
from cuba_tpu_torch.solver.structure import BAStructure


class ShardedSchurOperator(NamedTuple):
    """The matrix-free Schur operator over this shard's slots: each matvec
    runs the shard-local gather and segment work, then one [P, 6]
    all-reduce combines the pose-side sums (the replicated band or dense
    factorisation does O(P^2) work on every device; this does
    O(n_hpl / S) and one small collective a CG step)."""

    op: pcg.SchurOperator  # Hpp_d all-reduced; Hpl, W and the slot tables the shard's
    group: object

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        y2 = comm.all_reduce_sum(self.op.slot_product(x), self.group)
        return torch.einsum("pij,pj->pi", self.op.Hpp_d, x) - y2

    def block_diagonal(self) -> torch.Tensor:
        return self.op.Hpp_d - comm.all_reduce_sum(self.op.slot_diagonal(), self.group)


class MultiChipEngine(engine.BlockSolverEngine):
    """The LM loop over this rank's landmark shard (``BlockSolverEngine``'s
    loop, with ``group`` set).

    Solver resolution is the single-device engine's
    (:func:`engine.resolve_solver`: ``pcg`` stays sharded, ``band_cr`` where
    certified, the same ``auto`` gates), and the route follows plan
    feasibility in both dtypes: the rows route where every shard's rows
    plan holds (the v2 formation for the reduced solvers, or v1 on one
    shard), else the AoS body.  ``band_lr`` runs on the rows route only; on the AoS body it is
    an explicit ``dense_cholesky`` (``cuba_tpu``'s honest fallback).
    ``aos=True`` takes the AoS body without planning (the drivers' way to
    run it on a graph whose shards plan)."""

    def __init__(self, structure: BAStructure, kernels, config: BAConfig, group,
                 aos: bool = False):
        self.group = group
        self.global_structure = structure
        self.n_shards, self.rank = comm.size(group), comm.rank(group)
        with trace.span("engine"):
            device = engine.resolve_device(config)
            with trace.span("engine.resolve"):
                solver, band_m, pad_blocks, lr = engine.resolve_solver(structure, config)
            engine.check_solver(solver, config)
            with trace.span("engine.plan_rows"):
                sp = None if aos else rows_shard.plan_sharded(structure, group, device,
                                                              config.dtype, solver, pad_blocks,
                                                              lr)
            if sp is not None:
                local, plan, rc = sp
            else:
                if solver == "band_lr":
                    solver = "dense_cholesky"
                local = rows_shard.cut_shards(structure, self.n_shards)[self.rank]
                plan = rc = None
            self._setup(local, kernels, config, device, solver, band_m, pad_blocks, lr, plan,
                        rc)
        # the shard's active landmarks: ceil(L / S) on every shard
        self.base = local.num_l

    def _schur_operator(self, Hpp_d, Hpl, W):
        return ShardedSchurOperator(super()._schur_operator(Hpp_d, Hpl, W), self.group)

    def global_state(self, state: State) -> State:
        """The state of every landmark in global order on every rank: the
        shards' active landmarks gathered, then the fixed tail."""
        s = self.global_structure
        active = comm.all_gather_rows(state.Xws[:self.base], self.group)[:s.num_l]
        return State(state.qs, state.ts, torch.cat([active, state.Xws[self.base:]])
                     [:s.total_l])

    def gathered_landmarks(self, state: State) -> torch.Tensor:
        """[num_l, 3] active landmark estimates in global order."""
        return self.global_state(state).Xws[:self.global_structure.num_l]


def chi_squares_global(s: BAStructure, state: State) -> np.ndarray:
    """Per-edge unrobustified chi² of the whole structure at a global
    state, in the caller's edge insertion order (mono then stereo)."""
    out = []
    dev, dt = state.qs.device, state.qs.dtype
    cams = torch.as_tensor(s.cams, dtype=dt, device=dev)
    for ea, perm, mdim in ((s.mono, s.mono_perm, 2), (s.stereo, s.stereo_perm, 3)):
        if not ea.count:
            continue
        ec = assembly.EdgeConsts(
            torch.as_tensor(ea.measurements, dtype=dt, device=dev),
            torch.as_tensor(ea.omegas, dtype=dt, device=dev),
            torch.as_tensor(ea.pose_idx, dtype=torch.int64, device=dev),
            torch.as_tensor(ea.lm_idx, dtype=torch.int64, device=dev),
            None, None, None, None)  # no sums: no slots and no CSRs
        err, _Xc = assembly.edge_residuals(state.qs, state.ts, cams, state.Xws, ec, mdim)
        internal = assembly.chi_squares(err, ec.omega).cpu().numpy()
        original = np.empty_like(internal)
        original[perm] = internal
        out.append(original)
    return np.concatenate(out) if out else np.zeros(0)


class MultiChipSolverAdapter:
    """``BlockSolverEngine``-shaped facade over :class:`MultiChipEngine`, so
    that :class:`cuba_tpu_torch.BundleAdjustment` runs multi-device through
    ``BAConfig(mesh=...)``.  It keeps the shard's state between calls (the
    ``state`` handed to ``optimize`` is ignored, as ``cuba_tpu``'s adapter
    ignores it) and hands out global states: every landmark in global order
    on every rank, the fixed tail included."""

    def __init__(self, structure: BAStructure, kernels, config: BAConfig, mesh,
                 aos: bool = False):
        self.group = comm.group_of(mesh)
        self._mc = MultiChipEngine(structure, kernels, config, self.group, aos)
        self.structure = structure
        self.config = config
        self.device = self._mc.device
        self.dtype = self._mc.dtype
        self._local = self._mc.state

    def __getattr__(self, name):
        # the route and solver facts (solver, band_m, pad_blocks, path,
        # plan, lr, ...) are the shard engine's
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._mc, name)

    @property
    def state(self) -> State:
        return self._mc.global_state(self._local)

    def optimize(self, state, niterations: int, marks=None) -> LMResult:
        r = self._mc.optimize(self._local, niterations, marks)
        self._local = r.state
        return r._replace(state=self._mc.global_state(r.state))

    def optimize_profiled(self, state, niterations: int):
        r, prof = self._mc.optimize_profiled(self._local, niterations)
        self._local = r.state
        return r._replace(state=self._mc.global_state(r.state)), prof

    def chi_squares(self, state: Optional[State]) -> np.ndarray:
        """Per-edge chi² in insertion order, computed replicated from the
        global state."""
        return chi_squares_global(self.structure, self.state if state is None else state)

    def gathered_landmarks(self) -> torch.Tensor:
        return self._mc.gathered_landmarks(self._local)

