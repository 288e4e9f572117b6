"""The collectives of the landmark-sharded LM, over one process group.

Every function takes the group; ``group=None`` means one device, and then
each returns its input unchanged, so the single-device engine runs these
call sites as identities.  ``cuba_tpu`` puts a ``psum`` or ``pmax`` at each
place the engine calls one of these (``parallel/sharding.py``,
``solver/mxu.py``); the port adds :func:`all_gather_rows` for the final
landmarks and :func:`agree` for the route, decisions ``cuba_tpu`` takes
at trace time.

A result of ``all_reduce`` is the same bits on every rank (each element is
reduced once and sent to all), which keeps every host decision that reads
one the same on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch

AXIS = "landmarks"  # the mesh dimension the shards split


def group_of(mesh):
    """The process group of ``BAConfig.mesh``: None for None, the group
    itself, or a 1-D ``DeviceMesh``'s ``"landmarks"`` group."""
    if mesh is None or not hasattr(mesh, "get_group"):
        return mesh
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if names != (AXIS,):
        raise ValueError(f"a DeviceMesh for BAConfig.mesh must be 1-D with mesh_dim_names="
                         f"({AXIS!r},), got {names}")
    return mesh.get_group(AXIS)


def size(group) -> int:
    if group is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(group)


def rank(group) -> int:
    if group is None:
        return 0
    import torch.distributed as dist

    return dist.get_rank(group)


def _reduce(t: torch.Tensor, group, op: str) -> torch.Tensor:
    if group is None:
        return t
    import torch.distributed as dist

    out = t.contiguous().clone()
    dist.all_reduce(out, op=getattr(dist.ReduceOp, op), group=group)
    return out


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the group's ranks (``psum``)."""
    return _reduce(t, group, "SUM")


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``t`` over the group's ranks (``pmax``)."""
    return _reduce(t, group, "MAX")


def all_reduce_min(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise min of ``t`` (bool: the AND) over the group's ranks."""
    if group is None:
        return t
    if t.dtype == torch.bool:
        return _reduce(t.to(torch.int32), group, "MIN").bool()
    return _reduce(t, group, "MIN")


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` [n, ...] (one shape on every rank) stacked in rank
    order along dim 0: [size * n, ...]."""
    if group is None:
        return t
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def agree(flag: bool, group, device: Optional[torch.device] = None) -> bool:
    """True only where ``flag`` holds on every rank (an all-reduce MIN)."""
    t = torch.tensor(bool(flag), device=device)
    return bool(all_reduce_min(t, group))
