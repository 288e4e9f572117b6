"""Bring structures and states across from ``cuba_tpu`` without importing it.

``structure_from_numpy`` reads, by attribute, any object with the field
names of ``cuba_tpu``'s ``BAStructure`` (NumPy arrays), so the tests can run
both packages on one compiled structure.  ``landmarks_from_sharded``
takes ``cuba_tpu``'s sharded landmarks (``ShardedProblem.Xws`` [S, lm_pad,
3]) to global order; the port's ranks hand out global order themselves
(``MultiChipEngine.global_state``).
"""

from __future__ import annotations

import numpy as np
import torch

from cuba_tpu_torch.solver.engine import State
from cuba_tpu_torch.solver.structure import BAStructure, EdgeArrays


def _edges(e) -> EdgeArrays:
    return EdgeArrays(
        np.asarray(e.measurements, np.float64),
        np.asarray(e.omegas, np.float64),
        np.asarray(e.pose_idx, np.int32),
        np.asarray(e.lm_idx, np.int32),
    )


def structure_from_numpy(obj) -> BAStructure:
    """The port's structure from an object with BAStructure's field names."""
    pose_rank = getattr(obj, "pose_rank", None)
    return BAStructure(
        num_p=int(obj.num_p), num_l=int(obj.num_l),
        total_p=int(obj.total_p), total_l=int(obj.total_l),
        qs=np.asarray(obj.qs, np.float64), ts=np.asarray(obj.ts, np.float64),
        cams=np.asarray(obj.cams, np.float64), Xws=np.asarray(obj.Xws, np.float64),
        mono=_edges(obj.mono), stereo=_edges(obj.stereo),
        hpl_row=np.asarray(obj.hpl_row, np.int32),
        hpl_col=np.asarray(obj.hpl_col, np.int32),
        edge2hpl=np.asarray(obj.edge2hpl, np.int32),
        **{f: np.asarray(getattr(obj, f), np.int32)
           for f in ("hsc_row", "hsc_col", "mul_i", "mul_j", "mul_k")},
        mono_perm=np.asarray(obj.mono_perm, np.int64),
        stereo_perm=np.asarray(obj.stereo_perm, np.int64),
        lm_rank=np.asarray(obj.lm_rank, np.int64),
        pose_rank=None if pose_rank is None else np.asarray(pose_rank, np.int64),
        schur_native=getattr(obj, "schur_native", None),
    )


def state_from_numpy(qs, ts, Xws, device, dtype) -> State:
    """The port's LM state from (qs [P, 4], ts [P, 3], Xws [L, 3]) arrays."""

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return State(t(qs), t(ts), t(Xws))


def landmarks_from_sharded(Xws_s, lm_shard, lm_local, lm_pad_active: int = 0,
                           n_fixed: int = 0) -> np.ndarray:
    """``cuba_tpu``'s sharded landmarks (``ShardedProblem.Xws`` [S, lm_pad,
    3], ``lm_shard``, ``lm_local``) in global order: the active landmarks,
    then the ``n_fixed`` fixed ones from shard 0's tail at
    ``lm_pad_active``."""
    Xws_s = np.asarray(Xws_s)
    active = Xws_s[np.asarray(lm_shard), np.asarray(lm_local)]
    return np.concatenate([active, Xws_s[0, lm_pad_active:lm_pad_active + n_fixed]])
