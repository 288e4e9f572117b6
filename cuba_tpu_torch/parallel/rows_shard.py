"""Per-shard structures and rows plans of the landmark-sharded LM (port of
``cuba_tpu/parallel/mxu_shard.py``; ``cuba_tpu`` calls the rows front end
``mxu``).

1. :func:`cut_shards` cuts the global structure into S shard-local
   structures: the global poses and the global Hsc block pattern (``mul_k``
   stays a global block id, so the Schur tables of all shards sum into one
   key space), and the shard's own landmarks, edges, Hpl slots and
   triplets.  The landmark partition is contiguous, so each shard keeps
   the global locality order.  Both
   routes run on these shards: the rows route plans them, the AoS body
   (``cuba_tpu``'s XLA body, which cuts padded tables of its own) takes
   them as they are.  :func:`shard_structures` is ``cuba_tpu``'s cut, with
   its refusals.
2. :func:`plan_sharded` plans this rank's shard with ``rows.plan_rows``.
   Each rank runs its own program, so the plans need not trace alike as
   ``cuba_tpu``'s ``force_max`` fixpoint makes them; what must agree is the
   layout of every all-reduced tensor and the route.  Every shard carries
   the global pattern and the same ``pad_blocks``, so gT is [36, M*Wg] on
   every rank; the ranks take the rows route only where every shard plans
   (an all-reduce MIN of the flag, :func:`comm.agree`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from cuba_tpu_torch.solver import comm, rows
from cuba_tpu_torch.solver.structure import BAStructure, EdgeArrays


def _lm_owner(num_l: int, S: int) -> Tuple[np.ndarray, int]:
    """Contiguous landmark partition: owner = min(g // base, S - 1), base =
    ceil(L / S)."""
    base = -(-num_l // S) if num_l else 0
    if num_l == 0:
        return np.zeros(0, np.int64), 0
    owner = np.minimum(np.arange(num_l) // max(base, 1), S - 1)
    return owner, base


def shard_structures(s: BAStructure, S: int) -> Optional[List[BAStructure]]:
    """Cut the global structure into S shard-local structures
    (:func:`cut_shards`), or None where ``cuba_tpu``'s refuses: fewer
    active landmarks than shards, or a shard without slots.  At S = 1 the
    one shard is ``s`` itself, with its C++ Schur plan."""
    if S == 1:
        return [s] if s.num_l >= 1 and s.n_hpl else None
    if s.num_l < S:
        return None
    shards = cut_shards(s, S)
    return None if any(sh.n_hpl == 0 for sh in shards) else shards


def cut_shards(s: BAStructure, S: int) -> List[BAStructure]:
    """The S shard-local structures of ``s``, for any S >= 1.

    Every shard keeps the global poses and the global Hsc block pattern;
    landmarks, edges, Hpl slots and triplets are shard-local.  Every shard
    has the same ``base`` = ceil(L / S) active landmarks, the last ones
    padding without edges where the partition runs short (a shard may be
    all padding), and carries the replicated fixed-landmark tail; edges to
    fixed landmarks (pose terms only) are dealt round-robin.  The fields
    ``cuba_tpu``'s shards lack come from each shard's own arrays: identity
    edge permutations and landmark ranks, the global pose ranks, and no
    C++ Schur plan (the shard's triplets are planned in NumPy).  At S = 1
    the one shard is ``s`` itself."""
    if S == 1:
        return [s]
    num_l, total_l = s.num_l, s.total_l
    n_fixed = total_l - num_l
    owner, base = _lm_owner(num_l, S)
    total_l_s = base + n_fixed

    # slots: hpl_col is sorted ascending, so owners are non-decreasing and
    # each shard's slots form one contiguous global range
    col = np.asarray(s.hpl_col, np.int64)
    slot_owner = owner[col] if s.n_hpl else np.zeros(0, np.int64)
    slot_start = np.searchsorted(slot_owner, np.arange(S))
    slot_end = np.searchsorted(slot_owner, np.arange(S), side="right")
    # triplets: mul_i walks slots in ascending order (landmark-major)
    n_mul = int(np.asarray(s.mul_i).shape[0])
    trip_owner = slot_owner[np.asarray(s.mul_i, np.int64)] if n_mul else np.zeros(0, np.int64)
    trip_start = np.searchsorted(trip_owner, np.arange(S))
    trip_end = np.searchsorted(trip_owner, np.arange(S), side="right")

    def split_edges(ea: EdgeArrays, e_off: int):
        E = ea.count
        lm = np.asarray(ea.lm_idx, np.int64)
        if E:
            is_fixed = lm >= num_l
            own = np.where(is_fixed, np.arange(E) % S,
                           np.append(owner, 0)[np.minimum(lm, num_l)])
        else:
            own = np.zeros(0, np.int64)
        e2h = np.asarray(s.edge2hpl[e_off:e_off + E], np.int64)
        per, per_e2h = [], []
        for sh in range(S):
            sel = np.flatnonzero(own == sh)
            lml = lm[sel]
            lml = np.where(lml >= num_l, base + (lml - num_l), lml - sh * base)
            per.append(EdgeArrays(
                measurements=ea.measurements[sel],
                omegas=ea.omegas[sel],
                pose_idx=np.asarray(ea.pose_idx, np.int32)[sel],
                lm_idx=lml.astype(np.int32),
            ))
            n_hpl_sh = int(slot_end[sh] - slot_start[sh])
            e2 = e2h[sel]
            per_e2h.append(np.where(e2 < s.n_hpl, e2 - slot_start[sh], n_hpl_sh).astype(np.int64))
        return per, per_e2h

    mono_per, mono_e2h = split_edges(s.mono, 0)
    stereo_per, stereo_e2h = split_edges(s.stereo, s.mono.count)

    shards = []
    for sh in range(S):
        a, b = int(slot_start[sh]), int(slot_end[sh])
        ta, tb = int(trip_start[sh]), int(trip_end[sh])
        lo, hi = min(sh * base, num_l), min((sh + 1) * base, num_l)
        Xws = np.zeros((total_l_s, 3), s.Xws.dtype)
        Xws[:hi - lo] = s.Xws[lo:hi]
        if n_fixed:
            Xws[base:] = s.Xws[num_l:]
        shards.append(BAStructure(
            num_p=s.num_p, num_l=base, total_p=s.total_p, total_l=total_l_s,
            qs=s.qs, ts=s.ts, cams=s.cams, Xws=Xws,
            mono=mono_per[sh], stereo=stereo_per[sh],
            hpl_row=np.asarray(s.hpl_row, np.int64)[a:b],
            hpl_col=col[a:b] - sh * base,
            edge2hpl=np.concatenate([mono_e2h[sh], stereo_e2h[sh]]),
            hsc_row=s.hsc_row, hsc_col=s.hsc_col,  # global pattern (replicated formation)
            mul_i=np.asarray(s.mul_i, np.int64)[ta:tb] - a,
            mul_j=np.asarray(s.mul_j, np.int64)[ta:tb] - a,
            mul_k=np.asarray(s.mul_k, np.int64)[ta:tb],  # global block id
            mono_perm=np.arange(mono_per[sh].count, dtype=np.int64),
            stereo_perm=np.arange(stereo_per[sh].count, dtype=np.int64),
            lm_rank=np.arange(base, dtype=np.int64),
            pose_rank=s.pose_rank,
        ))
    return shards


def plan_sharded(s: BAStructure, group, device, dtype, solver: str, pad_blocks: int, lr=None):
    """This rank's shard and its rows plan: (shard structure, RowPlan,
    RowConsts), or None on every rank where any shard does not take the
    rows route (its shard structures or its plan fail, or, for a solver
    other than ``pcg`` on more than one shard, the plan lacks the v2
    band-major tables: the v1 formation is not all-reduced, as in
    ``cuba_tpu``; one shard takes it, as the single-device engine does).
    The plan is
    ``BlockSolverEngine``'s for the same solver: no Schur formation for
    ``pcg``, the dense placement table for ``dense_cholesky``, the loop
    plan ``lr`` for ``band_lr``."""
    shards = shard_structures(s, comm.size(group))
    local = plan = rc = None
    if shards is not None:
        local = shards[comm.rank(group)]
        plan, rc = rows.plan_rows(local, device, dtype,
                                  pad_blocks=0 if solver == "pcg" else pad_blocks,
                                  dense=solver == "dense_cholesky", lr=lr)
    ok = plan is not None and (solver == "pcg" or plan.v2 or comm.size(group) == 1)
    if not comm.agree(ok, group, device):
        return None
    return local, plan, rc
