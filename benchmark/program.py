"""The system under test, as the benchmark drives it: the port's array
entry (``build_structure_from_arrays``, ``BlockSolverEngine``,
``optimize``), the answer copied to the host, and the answer put back in
the caller's numbering.  Nothing else of the port is read, apart from the
counters of ``LMResult`` and the phase marks of ``engine.PhaseMarks``."""

from __future__ import annotations

import os

import numpy as np
import torch

from cuba_tpu_torch import native
from cuba_tpu_torch.config import BAConfig
from cuba_tpu_torch.ops import cudalib, robust
from cuba_tpu_torch.solver import engine as engine_mod
from cuba_tpu_torch.solver.structure import build_structure_from_arrays

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def libraries_built() -> list:
    """The port's libraries already built in its checkout (none on a
    checkout's first run, which compiles those it uses)."""
    libs = [cudalib.lib_path(name) for name in cudalib.SOURCES] + [native._LIB_PATH]
    return sorted(os.path.basename(p) for p in libs if os.path.exists(p))


def huber_kernels(deltas):
    """The port's robust-kernel tuple: Huber, mono then stereo."""
    return tuple((robust.HUBER, float(d)) for d in deltas)


def make_config(cfg: dict, dtype: str, device: str) -> BAConfig:
    lm = cfg["lm"]
    return BAConfig(dtype=DTYPES[dtype], device=device, solver=cfg["solver"],
                    tau=lm["tau"], max_inner_iterations=lm["max_inner"],
                    scale_eps=lm["scale_eps"], attenuation_min=lm["attenuation_min"],
                    attenuation_max=lm["attenuation_max"],
                    numerical_escalation=lm["escalation"])


def structure(prob):
    """Step 1: the symbolic pass over the problem's arrays."""
    P, L = prob.qs.shape[0], prob.Xws.shape[0]
    fixed_p = np.zeros(P, bool)
    fixed_p[prob.fixed_poses] = True
    return build_structure_from_arrays(
        prob.qs, prob.ts, np.tile(prob.cam, (P, 1)), prob.Xws, fixed_p, np.zeros(L, bool),
        prob.mono_p, prob.mono_l, prob.mono_z, prob.mono_w,
        prob.stereo_p, prob.stereo_l, prob.stereo_z, prob.stereo_w)


def engine(s, deltas, config: BAConfig):
    """Step 2: the planner and the upload."""
    return engine_mod.BlockSolverEngine(s, huber_kernels(deltas), config)


def phase_marks(eng):
    return engine_mod.PhaseMarks(eng.device)


SCHUR_PHASE = "4: Schur Complement"


def solve(eng, iterations: int, marks=None):
    """Steps 3 and 4: ``optimize`` from the engine's initial state, and the
    final state copied to the host.  Returns (LMResult, (qs, ts, Xws) on
    the host, in the engine's numbering)."""
    res = eng.optimize(None, iterations, marks)
    st = res.state
    return res, (st.qs.cpu(), st.ts.cpu(), st.Xws.cpu())


def caller_order(s, host_state, fixed_poses):
    """The answer (qs [P, 4], ts [P, 3], Xws [L, 3]) in the caller's
    numbering, as float64 NumPy arrays.  ``build_structure_from_arrays``
    numbers the free poses first in index order and the fixed ones after
    them, then applies its band permutation to the free poses and its
    locality renumbering to the landmarks (none of which is fixed here)."""
    qs, ts, Xws = (a.double().numpy() for a in host_state)
    P = s.total_p
    fixed = np.zeros(P, bool)
    fixed[np.asarray(fixed_poses, np.int64)] = True
    order = np.concatenate([np.nonzero(~fixed)[0], np.nonzero(fixed)[0]])
    internal = np.empty(P, np.int64)
    internal[order] = np.arange(P)
    if s.pose_rank is not None:
        free = internal < s.num_p
        internal[free] = s.pose_rank[internal[free]]
    lm_internal = np.arange(s.total_l)
    lm_internal[:s.num_l] = s.lm_rank
    return qs[internal], ts[internal], Xws[lm_internal]
