"""Gathers, segment sums and the Schur formation over transposed
``[D, N]`` fp32 or fp64 tables.

Port of the ten one-hot-matmul Pallas kernels of ``cuba_tpu/ops/segmm.py``.
Each wrapper keeps its output shape and layout and invalid-id rules; its
output takes its inputs' dtype:

* ``gather``: ``out[:, n] = src[:, ids[n]]``, 0 where ``ids[n] < 0`` or
  ``>= S`` (the sites of the TPU's ``resident_gather``,
  ``windowed_gather`` and ``tiled_gather``);
* ``segsum``: ``out[:, s] = sum of vals[:, n] over ids[n] == s`` for
  ``0 <= s < num_out``; other ids are dropped (the sites of
  ``accum_segsum``, ``accum_segsum_windowed`` and ``tiled_segsum``);
* ``schur_fused``: per-chunk windowed W (x) Hpl pair products, [36, C*kwin];
* ``compact_to_band``: the band-major compact Schur table placed into
  block-tridiagonal storage [M*384, 768];
* ``compact_to_dense``: the same table placed into the dense damped Schur
  matrix [6PB, 6PB];
* ``band_transpose``: the v1 formation's dense block table [36, PB, PB]
  interleaved into the dense matrix [6PB, 6PB].

The TPU kernels' windows and tiles only kept a one-hot factor inside VMEM;
the card needs none of them.  Underneath, six hand-written CUDA kernels
(``csrc/segmm.cu``) serve the six wrappers: a column gather, a
deterministic CSR segment sum, a per-lane CSR pair-product sum, two
table-driven placements (band and dense) and a lane-interleave copy.  The
CSRs and the placement tables of a call site are built once per structure
by the planner (``solver/rows.py``); the kernels need them, and only the
segment sum builds a missing CSR on the spot (which only tests do).

Dispatch (``ops/cudalib.py``): a CPU tensor takes the ``*_plain`` torch
version, a CUDA tensor the kernel built for its dtype (float32: entry
``cuba_<name>``; float64: ``cuba_<name>_f64``; anything else, or a call
mixing the two, raises: there is no fallback).
:func:`use_plain` switches CUDA tensors to the plain versions too, for the
comparisons in the tests and ``chip_smoke.py``.  Every kernel launch adds
one to ``LAUNCHES[wrapper name]`` (``gather``, ``segsum``,
``schur_fused``, ...), an fp64 one to ``LAUNCHES_F64`` too.

The one host plan, :class:`SchurPlan` (:func:`plan_schur`, a NumPy copy of
``cuba_tpu``'s), is a bound of the card too: ``schur_fused``'s chunks and
their shared-memory window.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from cuba_tpu_torch import native, trace
from cuba_tpu_torch.ops import cudalib
# re-exported: the launch counts, the plain-version switch and the build
from cuba_tpu_torch.ops.cudalib import (  # noqa: F401
    LAUNCHES, LAUNCHES_F64, build_kernels, reset_launches, use_plain)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# (chunk, slot_block, max_kwin) of the fused Schur plan, the geometry the
# C++ pass plans at too
SC_GEOMETRY = native.SC_GEOMETRY


@dataclasses.dataclass(frozen=True)
class SchurPlan:
    """Chunk metadata of schur_fused: triplets in landmark order, in chunks
    of ``chunk``.  Chunk c reads W/Hpl slots from the two ``slot_block``
    blocks starting at block sb[c] and writes its ``kwin`` output lanes;
    li/lj/lk are the local ids (-1 on padding), gid the global Hsc block
    of each output lane (-1 on padding)."""

    chunk: int
    slot_block: int
    kwin: int
    num_chunks: int
    sb: np.ndarray  # [C] int32
    li: np.ndarray  # [C*chunk] int32
    lj: np.ndarray  # [C*chunk] int32
    lk: np.ndarray  # [C*chunk] int32
    gid: np.ndarray  # [C*kwin] int32
    n_slot_pad: int
    n_hsc_pad: int
    ok: bool


def _chunk_by_landmark(mi, mj, mk, col, chunk, slot_block):
    """Greedy landmark-granular chunking of the landmark-major triplet
    streams: close a chunk early (padding with -1) where the next
    landmark's triplets would overflow it or push its slot window past
    2*slot_block.  Returns padded (mi, mj, mk, num_chunks)."""
    n = mi.size
    lm = col[mi]
    starts = np.flatnonzero(np.concatenate(([True], lm[1:] != lm[:-1])))
    ends = np.append(starts[1:], n)
    counts = ends - starts
    lo_r = np.minimum.reduceat(np.minimum(mi, mj), starts)
    hi_r = np.maximum.reduceat(np.maximum(mi, mj), starts)
    if int(counts.max()) > chunk or int((hi_r - lo_r).max()) >= 2 * slot_block:
        # one landmark alone overflows: pack densely, the plan is infeasible
        C = max((n + chunk - 1) // chunk, 1)
        pad = np.full(C * chunk - n, -1, np.int64)
        return np.concatenate([mi, pad]), np.concatenate([mj, pad]), np.concatenate([mk, pad]), C
    win = 2 * slot_block
    new_start = np.empty(starts.size, np.int64)  # padded position of each run
    cid = cur_n = 0
    cur_lo, cur_hi = np.int64(0), np.int64(-1)
    for r in range(starts.size):
        c_, l_, h_ = counts[r], lo_r[r], hi_r[r]
        if cur_n:
            nlo, nhi = min(cur_lo, l_), max(cur_hi, h_)
            if cur_n + c_ > chunk or nhi >= (nlo // slot_block) * slot_block + win:
                cid += 1
                cur_n = 0
        if cur_n == 0:
            cur_lo, cur_hi = l_, h_
        else:
            cur_lo, cur_hi = min(cur_lo, l_), max(cur_hi, h_)
        new_start[r] = cid * chunk + cur_n
        cur_n += c_
    C = cid + 1
    pos = np.repeat(new_start - starts, counts) + np.arange(n, dtype=np.int64)
    out = []
    for a in (mi, mj, mk):
        p = np.full(C * chunk, -1, np.int64)
        p[pos] = a
        out.append(p)
    return out[0], out[1], out[2], C


def plan_schur(mul_i, mul_j, mul_k, n_hpl: int, n_hsc: int, *, chunk: int = 1024,
               slot_block: int = 512, max_kwin: int = 1024, precomputed=None,
               col: Optional[np.ndarray] = None) -> SchurPlan:
    """The schur_fused chunk plan (NumPy copy of cuba_tpu's plan_schur).
    ``precomputed`` is the C++ pass's plan (BAStructure.schur_native), taken
    as is when its geometry matches; ``col`` (slot -> landmark) enables the
    landmark-granular re-chunk."""
    if precomputed is not None and precomputed[0] == (chunk, slot_block, max_kwin):
        kwin, ok, C, n_slot_pad, n_hsc_pad, sb, li, lj, lk, gid = precomputed[1:]
        return SchurPlan(chunk, slot_block, int(kwin), C, sb, li, lj, lk,
                         gid, n_slot_pad, n_hsc_pad, ok)
    mul_i, mul_j, mul_k = (np.asarray(a) for a in (mul_i, mul_j, mul_k))
    n_mul = int(mul_i.size)
    order = np.argsort(mul_i, kind="stable")  # landmark-major slot order
    mi, mj, mk = mul_i[order], mul_j[order], mul_k[order]
    big = np.int64(1) << 40
    if col is not None and n_mul:
        mi, mj, mk, C = _chunk_by_landmark(
            mi.astype(np.int64), mj.astype(np.int64), mk.astype(np.int64),
            np.asarray(col, np.int64), chunk, slot_block)
    else:
        C = max((n_mul + chunk - 1) // chunk, 1)
        pad = np.full(C * chunk - n_mul, -1, np.int64)
        mi, mj, mk = (np.concatenate([a, pad]) for a in (mi, mj, mk))
    mi2, mj2, mk2 = (a.reshape(C, chunk) for a in (mi, mj, mk))
    valid = mi2 >= 0
    smin = np.where(valid, np.minimum(mi2, mj2), big).min(axis=1)
    smax = np.where(valid, np.maximum(mi2, mj2), -1).max(axis=1)
    none = smax < 0
    smin[none] = 0
    smax[none] = 0
    sb = (smin // slot_block).astype(np.int32)
    ok = bool(np.all(smax - sb.astype(np.int64) * slot_block < 2 * slot_block))
    li = np.where(valid, mi2 - sb[:, None].astype(np.int64) * slot_block, -1)
    lj = np.where(valid, mj2 - sb[:, None].astype(np.int64) * slot_block, -1)

    # compact per-chunk block lists: the sorted distinct mk of each chunk
    mk_sorted = np.sort(np.where(valid, mk2, big), axis=1)
    isnew = np.ones_like(mk_sorted, dtype=bool)
    isnew[:, 1:] = mk_sorted[:, 1:] != mk_sorted[:, :-1]
    isnew &= mk_sorted < big
    counts = isnew.sum(axis=1)
    kwin = min(max_kwin, max(_round_up(int(counts.max()) if C else 1, 128), 128))
    ok = ok and bool(counts.max() <= kwin if C else True)
    gid = np.full((C, kwin), -1, np.int64)
    if C and ok:
        rank = np.cumsum(isnew, axis=1) - 1
        rows, cols = np.nonzero(isnew)
        gid[rows, rank[rows, cols]] = mk_sorted[rows, cols]
        # local lane of each triplet: one searchsorted over the row-wise
        # sorted lists, made globally ascending with per-chunk offsets
        stride = np.int64(n_hsc + 2)
        offs = (np.arange(C, dtype=np.int64) * stride)[:, None]
        flat = (np.where(gid >= 0, gid, stride - 1) + offs).reshape(-1)
        queries = (np.where(valid, mk2, 0) + offs).reshape(-1)
        lk = np.searchsorted(flat, queries).astype(np.int64) - (
            np.repeat(np.arange(C, dtype=np.int64), chunk) * kwin)
        lk = np.where(valid.reshape(-1), lk, -1).reshape(C, chunk)
    else:
        lk = np.where(valid, mk2, -1)
    n_slot_pad = max((int(sb.max()) + 2) * slot_block if C else slot_block,
                     _round_up(n_hpl, slot_block))
    return SchurPlan(
        chunk, slot_block, kwin, C, sb,
        li.reshape(-1).astype(np.int32), lj.reshape(-1).astype(np.int32),
        lk.reshape(-1).astype(np.int32), gid.reshape(-1).astype(np.int32),
        n_slot_pad, _round_up(n_hsc, 128), ok,
    )


class SegmentCSR(NamedTuple):
    """The fixed summation order of one segment-sum call site."""

    order: torch.Tensor  # [M] int32: input columns with a valid id, stably sorted by id
    offs: torch.Tensor  # [num_out + 1] int32: segment s is order[offs[s]:offs[s+1]]
    group: int = 1  # lanes per segment in the CUDA kernel (group_width)
    # [num_live] int32, the non-empty segments, where nearly all are empty
    # (the kernel then zeroes the output and sums only these); else None
    live: Optional[torch.Tensor] = None
    # schur_lane_csr only: [M] int32, li | lj << 16 of entry q's triplet
    # (-1 where it is dropped), what schur_fused's kernel reads per entry;
    # and [num_out] int32, the order its threads take the lanes in
    pairs: Optional[torch.Tensor] = None
    lane_order: Optional[torch.Tensor] = None


MAX_GROUP = 32  # one warp
MAX_ROWS = 4  # accumulators per lane in the CUDA kernel
SPARSE_EMPTY = 0.97  # the share of empty segments above which a CSR may list the others


def group_width(mean: float) -> int:
    """The segment sum's lanes per segment, for segments of ``mean``
    entries on average: the smallest power of two at or above mean / 4,
    capped at a warp, so that a lane walks about four entries.  Long
    segments then get 32 lanes of independent loads, segments of 0-4
    entries a lane each.  It fixes the summation order (``walks.segsum_walk``)."""
    g = 1
    while 4 * g < mean and g < MAX_GROUP:
        g *= 2
    return g


L2_BYTES = 50 << 20  # the H100's L2


def row_chunk(D: int, N: int, group: int) -> int:
    """Rows per chunk of the CUDA segment sum (each chunk a grid row of its
    own; the chunking leaves every output's summation order as it is).
    Long segments (a full warp per segment) over values of more than half
    the L2 take one row a chunk: their columns are scattered, and the row
    that the resident groups read then stays in L2 while neighbouring
    segments reuse its sectors.  Otherwise the fewest chunks of at most
    MAX_ROWS rows, each column's id loaded once for as many rows as a lane
    holds."""
    if D == 0:
        return 1
    if group == MAX_GROUP and 4 * D * N > L2_BYTES // 2:
        return 1
    chunks = -(-D // MAX_ROWS)
    return -(-D // chunks)


def _csr_host(ids, num_out: int):
    """:func:`segment_csr`'s tables on the host: (order, offs, group, live
    or None), the index arrays int32."""
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    ids = np.asarray(ids, np.int64)
    pos = np.flatnonzero((ids >= 0) & (ids < num_out))
    order = pos[np.argsort(ids[pos], kind="stable")]
    counts = np.bincount(ids[pos], minlength=num_out)
    offs = np.zeros(num_out + 1, np.int64)
    np.cumsum(counts, out=offs[1:])
    live = np.flatnonzero(counts)
    group = group_width(pos.size / num_out) if num_out else 1
    listed = group_width(pos.size / live.size) if live.size else 1
    sparse = live.size < (1 - SPARSE_EMPTY) * num_out and listed > group
    return (order.astype(np.int32), offs.astype(np.int32), listed if sparse else group,
            live.astype(np.int32) if sparse else None)


def _upload(a: Optional[np.ndarray], device) -> Optional[torch.Tensor]:
    return None if a is None else torch.from_numpy(a).to(device)


def segment_csr(ids, num_out: int, device) -> SegmentCSR:
    """CSR of ``ids`` over ``num_out`` segments; ids outside [0, num_out)
    are left out.  It lists its non-empty segments where more than
    SPARSE_EMPTY of them are empty and the listed ones take a wider group
    than all of them would; its group width is :func:`group_width` of the
    mean length of the segments the kernel walks.  Built on the host, then
    uploaded (the span ``engine.upload``)."""
    order, offs, group, live = _csr_host(ids, num_out)
    with trace.span("engine.upload"):
        return SegmentCSR(_upload(order, device), _upload(offs, device), group,
                          _upload(live, device))


def schur_lane_csr(plan: SchurPlan, device) -> SegmentCSR:
    """schur_fused's summation order: for every output lane c*kwin + l, the
    chunk's triplet positions t with lk[t] == l, in ascending t; its
    ``pairs``, li[t] | lj[t] << 16 of each entry (-1 where li or lj lies
    outside [0, 2*slot_block)), so that the kernel reads one coalesced
    table, not order, li and lj in turn; and its ``lane_order``
    (:func:`schur_lane_order`).  Built once per structure."""
    lk = np.asarray(plan.lk, np.int64)
    chunk_of = np.arange(lk.size, dtype=np.int64) // plan.chunk
    lanes = np.where(lk >= 0, chunk_of * plan.kwin + lk, -1)
    t, offs, group, live = _csr_host(lanes, plan.num_chunks * plan.kwin)
    li, lj = np.asarray(plan.li, np.int64)[t], np.asarray(plan.lj, np.int64)[t]
    win = 2 * plan.slot_block
    keep = (li >= 0) & (lj >= 0) & (li < win) & (lj < win)
    pairs = np.where(keep, li | (lj << 16), -1).astype(np.int32)
    order = schur_lane_order(np.diff(offs), plan.kwin)
    with trace.span("engine.upload"):
        return SegmentCSR(_upload(t, device), _upload(offs, device), group,
                          _upload(live, device), pairs=_upload(pairs, device),
                          lane_order=_upload(order, device))


SCHUR_PASS = 128  # lanes of one group of the lane order and of one pass of the kernel


def schur_lane_order(lengths: np.ndarray, kwin: int) -> np.ndarray:
    """The order schur_fused's threads take a chunk's lanes in: within each
    group of SCHUR_PASS consecutive lanes, by descending length (ties by
    lane), as local lane ids [C*kwin] int32, so that a warp walks lanes of
    about one length and the longest start first.  It moves no sum: each
    output keeps its lane's order."""
    g = np.asarray(lengths, np.int64).reshape(-1, SCHUR_PASS)
    local = np.argsort(-g, axis=1, kind="stable")
    base = (np.arange(g.shape[0]) * SCHUR_PASS % kwin)[:, None]
    return (local + base).reshape(-1).astype(np.int32)


BAND_TILE = 64  # pose blocks per CR block: 384 = 64 * 6 scalars
_MIRROR = np.int32(1 << 30)


def band_table(iru, icu, PB: int) -> np.ndarray:
    """compact_to_band's placement table [PB, 128] int32: for pose row p and
    local pose column q (global column (p // 64) * 64 + q) the band slot
    whose 6x6 block lands there, with bit 30 set where the block is read
    transposed (a mirror); -1 where none does.  Every output block has at
    most one source: uppers have row <= col, mirrors row > col."""
    if isinstance(iru, torch.Tensor):
        iru, icu = iru.cpu().numpy(), icu.cpu().numpy()
    iru = np.asarray(iru, np.int64)
    icu = np.asarray(icu, np.int64)
    tab = np.full((PB, 2 * BAND_TILE), -1, np.int32)
    s = np.flatnonzero(iru >= 0)
    r, c = iru[s], icu[s]
    rbase = (r // BAND_TILE) * BAND_TILE
    up = (c >= rbase) & (c < rbase + 2 * BAND_TILE)  # tile (k, 0) or (k, 1)
    tab[r[up], (c - rbase)[up]] = s[up]
    cbase = (c // BAND_TILE) * BAND_TILE
    mir = (r != c) & (r >= cbase)  # the transposed read, inside tile (k, 0)
    tab[c[mir], (r - cbase)[mir]] = s[mir].astype(np.int32) | _MIRROR
    return tab


def dense_table(iru, icu, PB: int) -> np.ndarray:
    """compact_to_dense's placement table [PB, PB] int32: for pose block
    (p, q) the band slot whose 6x6 block lands there, with bit 30 set where
    it is read transposed (a mirror); -1 where none does.  Every output
    block has at most one source: uppers have row <= col, mirrors row > col;
    the diagonal blocks take their upper block and the damped diagonal.  At
    the dense solver's cap of 4096 pose blocks it takes 64 MB, built once per
    structure."""
    if isinstance(iru, torch.Tensor):
        iru, icu = iru.cpu().numpy(), icu.cpu().numpy()
    iru = np.asarray(iru, np.int64)
    icu = np.asarray(icu, np.int64)
    s = np.flatnonzero(iru >= 0)
    r, c = iru[s], icu[s]
    if np.any(r > c):
        raise ValueError("compact Schur blocks must have row <= col")
    tab = np.full((PB, PB), -1, np.int32)
    tab[r, c] = s
    mir = r != c
    tab[c[mir], r[mir]] = s[mir].astype(np.int32) | _MIRROR
    return tab


# ---------------------------------------------------------------------------
# the CUDA library: csrc/segmm.cu, built and bound by cudalib
# ---------------------------------------------------------------------------

KERNEL_SRC = cudalib.SOURCES["segmm"]
_i64, _vp = ctypes.c_int64, ctypes.c_void_p
_SIGNATURES = {
    "cuba_gather_cols": [_vp, _vp, _vp, _i64, _i64, _i64, _vp],
    "cuba_segsum_csr": [_vp, _vp, _vp, _vp, _i64, _vp, _i64, _i64, _i64, _i64, _i64, _vp],
    "cuba_schur_fused": [_vp, _vp, _i64, _vp, _vp, _vp, _vp, _i64, _i64, _i64, _i64, _vp, _vp],
    "cuba_compact_to_band": [_vp, _i64, _vp, _vp, _i64, _vp, _i64, _vp, _vp],
    "cuba_segmm_attributes": [_i64, _i64, _vp],
    "cuba_compact_to_dense": [_vp, _i64, _vp, _vp, _i64, _vp, _vp, _vp],
    "cuba_band_transpose": [_vp, _vp, _i64, _vp, _vp],
}
# each entry's fp64 twin takes the same arguments
_SIGNATURES.update({cudalib.symbol(k, torch.float64): v for k, v in list(_SIGNATURES.items())})


def _kernel_lib() -> ctypes.CDLL:
    return cudalib.library("segmm", _SIGNATURES)


def _entry(name: str, dtype: torch.dtype):
    """The library's entry point ``name`` built for ``dtype``."""
    return getattr(_kernel_lib(), cudalib.symbol(name, dtype))


def _launch_gather(src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    dt = cudalib.float_dtype(src)
    cudalib.check(src, "src", dt, 2)
    cudalib.check(ids, "ids", torch.int32, 1)
    D, S = src.shape
    N = ids.shape[0]
    cudalib.check_int32("gather_cols", D * S, D * N)
    out = torch.empty((D, N), dtype=dt, device=src.device)
    if D * N == 0:
        return out
    cudalib.call("gather_cols", src, _entry("cuba_gather_cols", dt),
                 src.data_ptr(), ids.data_ptr(), out.data_ptr(), D, S, N)
    cudalib.count("gather", dt)
    return out


def _launch_segsum(vals: torch.Tensor, num_out: int, csr: SegmentCSR) -> torch.Tensor:
    dt = cudalib.float_dtype(vals)
    cudalib.check(vals, "vals", dt, 2)
    cudalib.check(csr.order, "csr.order", torch.int32, 1)
    cudalib.check(csr.offs, "csr.offs", torch.int32, 1)
    if csr.offs.shape[0] != num_out + 1:
        raise ValueError(f"csr.offs has {csr.offs.shape[0]} entries, expected {num_out + 1}")
    if csr.live is not None:
        cudalib.check(csr.live, "csr.live", torch.int32, 1)
    for t in (csr.order, csr.offs, csr.live):
        if t is not None and t.device != vals.device:
            raise ValueError("csr tensors must be on the device of vals")
    D, N = vals.shape
    cudalib.check_int32("segsum_csr", D * N, D * num_out, num_out * MAX_GROUP)
    out = torch.empty((D, num_out), dtype=dt, device=vals.device)
    if D * num_out == 0:
        return out
    live, num_live = (None, 0) if csr.live is None else (csr.live.data_ptr(), csr.live.numel())
    cudalib.call("segsum_csr", vals, _entry("cuba_segsum_csr", dt),
                 vals.data_ptr(), csr.order.data_ptr(), csr.offs.data_ptr(), live, num_live,
                 out.data_ptr(), D, N, num_out, csr.group, row_chunk(D, N, csr.group))
    cudalib.count("segsum", dt)
    return out


# ---------------------------------------------------------------------------
# the gather and the segment sum, and their plain versions
# ---------------------------------------------------------------------------


def gather_plain(src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    valid = (ids >= 0) & (ids < src.shape[1])
    safe = torch.where(valid, ids, torch.zeros_like(ids)).long()
    return torch.where(valid[None, :], src[:, safe], torch.zeros((), dtype=src.dtype,
                                                                   device=src.device))


def gather(src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Column gather, src [D, S] by ids [N] -> [D, N]: ``out[:, n] =
    src[:, ids[n]]``, 0 where ``ids[n] < 0`` or ``>= S``.  Every gather of
    the port (the call sites of cuba_tpu's ``resident_gather``,
    ``windowed_gather`` and ``tiled_gather``); on the card one
    ``gather_cols`` launch, exact."""
    with trace.span("k.gather_cols"):
        if cudalib.use_kernel(src, ids):
            return _launch_gather(src, ids)
        return gather_plain(src, ids)


def segsum_plain(vals: torch.Tensor, ids: torch.Tensor, num_out: int) -> torch.Tensor:
    """:func:`segsum` in torch, in ``index_add_``'s order."""
    valid = (ids >= 0) & (ids < num_out)
    out = torch.zeros((vals.shape[0], num_out), dtype=vals.dtype, device=vals.device)
    return out.index_add_(1, ids[valid].long(), vals[:, valid])


def segsum(vals: torch.Tensor, ids: torch.Tensor, num_out: int,
           csr: Optional[SegmentCSR] = None) -> torch.Tensor:
    """Segment sum, vals [D, N] by ids [N] -> [D, num_out]: ``out[:, s] =
    sum of vals[:, n] over ids[n] == s`` for ``0 <= s < num_out``; other ids
    are dropped.  Every segment sum of the port (the call sites of
    cuba_tpu's ``accum_segsum``, ``accum_segsum_windowed`` and
    ``tiled_segsum``); on the card one ``segsum_csr`` launch in the fixed
    order of ``csr`` (:func:`segment_csr` of ``ids``, built once per
    structure by the planner; built here where it is missing, which only
    tests do)."""
    with trace.span("k.segsum_csr"):
        if cudalib.use_kernel(vals, ids):
            if csr is None:
                csr = segment_csr(ids, num_out, vals.device)
            return _launch_segsum(vals, num_out, csr)
        return segsum_plain(vals, ids, num_out)


# ---------------------------------------------------------------------------
# the v2 Schur formation: schur_fused and compact_to_band
# ---------------------------------------------------------------------------


def schur_fused_plain(W, G, plan: SchurPlan, sb, li, lj, lk):
    """Plain torch schur_fused: every chunk's pair products, gathered from
    its slot window and summed into its output lanes."""
    C, R, KW, SB = plan.num_chunks, plan.chunk, plan.kwin, plan.slot_block
    base = (sb.long() * SB).repeat_interleave(R)
    valid = (li >= 0) & (lj >= 0) & (lk >= 0)
    i = torch.where(valid, base + li.long(), torch.zeros_like(base))
    j = torch.where(valid, base + lj.long(), torch.zeros_like(base))
    prod = torch.einsum("akt,bkt->abt", W[:, i].view(6, 3, -1),
                        G[:, j].view(6, 3, -1)).reshape(36, -1)
    lane = torch.arange(C * R, device=W.device) // R * KW + lk.long()
    out = torch.zeros((36, C * KW), dtype=W.dtype, device=W.device)
    return out.index_add_(1, lane[valid], prod[:, valid])


SCHUR_WINDOW = 512  # slots a chunk reads from W and from G (2 * slot_block; kScWin)
SCHUR_SLOT = 20  # floats of a staged fp32 slot: its 18 values, padded to 5 float4 (kSlot)
SCHUR_SLOT_F64 = 18  # doubles of a staged fp64 slot: its 18 values, 9 double2, no padding
_SCHUR_SLOTS = {torch.float32: SCHUR_SLOT, torch.float64: SCHUR_SLOT_F64}
SCHUR_THREADS = 256  # threads a block (one block per chunk; kScThreads), six a lane


def schur_fused_launch(plan: SchurPlan, dtype: torch.dtype = torch.float32) -> dict:
    """``schur_fused_kernel``'s launch at the plan for ``dtype``: a ``grid``
    of one block per chunk, ``threads`` a block and ``smem`` dynamic shared
    bytes (the W and G windows [2, 512, slot] values, slot SCHUR_SLOT in
    fp32 and SCHUR_SLOT_F64 in fp64; the chunk's pairs, lane offsets and
    lane order padded to 4 ints; and a [36, 132] output tile of values)."""
    ints = (plan.chunk + 2 * plan.kwin + 1 + 3) // 4 * 4
    values = 2 * SCHUR_WINDOW * _SCHUR_SLOTS[dtype] + 36 * (SCHUR_PASS + 4)
    return dict(grid=[plan.num_chunks], threads=SCHUR_THREADS,
                smem=dtype.itemsize * values + 4 * ints)


def kernel_attributes(name: str, launch: dict, dtype: torch.dtype = torch.float32) -> dict:
    """What the build made of ``schur_fused``'s, ``compact_to_band``'s or
    ``compact_to_dense``'s kernel for ``dtype``: ``registers`` and
    ``spill_bytes`` a thread, and ``blocks_per_sm`` at the launch's threads
    and dynamic shared bytes (schur_fused's alone; on the card only)."""
    which = {"compact_to_band": 0, "schur_fused": 1, "compact_to_dense": 2}[name]
    out = (ctypes.c_int64 * 4)()
    err = _entry("cuba_segmm_attributes", dtype)(which, launch["smem"] if which == 1 else 0,
                                                  ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"{name}: kernel attributes not read (cudaError {err})")
    return dict(registers=out[0], spill_bytes=out[1], blocks_per_sm=out[3])


def schur_fused(W, G, plan: SchurPlan, sb, li, lj, lk, *, csr: Optional[SegmentCSR] = None):
    """Per-chunk windowed pair products (cuba_tpu segmm.schur_fused):
    out[a*6+b, c*kwin + lk[t]] += sum_m W[3a+m, sb[c]*SB + li[t]] *
    G[3b+m, sb[c]*SB + lj[t]] over chunk c's triplets t; -1 ids dropped.
    W, G [18, >= n_slot_pad] -> [36, C*kwin].  ``csr`` is
    :func:`schur_lane_csr` of the plan, built once per structure; the
    kernel needs it, and W and G 16-byte aligned with a row length that is
    a multiple of 4 (its 16-byte window copies), else it raises.  On the
    card each output is summed in the order of ``walks.schur_fused_walk``."""
    with trace.span("k.schur_fused"):
        C, KW = plan.num_chunks, plan.kwin
        for t, name in ((W, "W"), (G, "G")):
            if t.dim() != 2 or t.shape[0] != 18 or t.shape[1] < plan.n_slot_pad:
                raise ValueError(f"{name}: expected [18, >= {plan.n_slot_pad}], "
                                 f"got {tuple(t.shape)}")
        if G.shape != W.shape:
            raise ValueError(f"W {tuple(W.shape)} and G {tuple(G.shape)} differ")
        if (sb.shape[0] != C or li.shape[0] != C * plan.chunk or lj.shape[0] != li.shape[0]
                or lk.shape[0] != li.shape[0]):
            raise ValueError("sb/li/lj/lk do not match the plan")
        if not cudalib.use_kernel(W, G, sb, li, lj, lk):
            return schur_fused_plain(W, G, plan, sb, li, lj, lk)
        dt = cudalib.float_dtype(W, G)
        for t, name in ((W, "W"), (G, "G")):
            cudalib.check(t, name, dt, 2)
            if t.data_ptr() % 16 or t.shape[1] * t.element_size() % 16:
                raise ValueError(f"schur_fused: {name} must be 16-byte aligned with rows of a "
                                 f"multiple of 16 bytes (16-byte window copies)")
        cudalib.check(sb, "sb", torch.int32, 1)
        if csr is None or csr.pairs is None or csr.lane_order is None:
            raise ValueError("schur_fused: the kernel needs csr=schur_lane_csr(plan, device)")
        for t, name in ((csr.pairs, "csr.pairs"), (csr.offs, "csr.offs"),
                        (csr.lane_order, "csr.lane_order")):
            cudalib.check(t, name, torch.int32, 1)
            if t.device != W.device:
                raise ValueError("csr does not match the device")
        if (csr.offs.shape[0] != C * KW + 1 or csr.pairs.shape != csr.order.shape
                or csr.lane_order.shape[0] != C * KW):
            raise ValueError("csr does not match the plan")
        if 2 * plan.slot_block != SCHUR_WINDOW or KW % SCHUR_PASS:
            raise ValueError(f"schur_fused: the kernel takes a {SCHUR_WINDOW}-slot window and "
                             f"kwin a multiple of {SCHUR_PASS}, not slot_block {plan.slot_block}, "
                             f"kwin {KW}")
        out = torch.empty((36, C * KW), dtype=dt, device=W.device)
        cudalib.call("schur_fused", W, _entry("cuba_schur_fused", dt),
                     W.data_ptr(), G.data_ptr(), W.shape[1], sb.data_ptr(), csr.pairs.data_ptr(),
                     csr.offs.data_ptr(), csr.lane_order.data_ptr(), plan.slot_block, plan.chunk,
                     KW, C, out.data_ptr())
        cudalib.count("schur_fused", dt)
        return out


def compact_to_band_plain(gT, iru, icu, dbT, occ_band, PB: int, Wg: int):
    """Plain torch compact_to_band: uppers, transposed mirrors and the
    damped diagonal placed into [M, 64, 6, 2, 64, 6] = tile (k, e) element
    (pose row, i, pose col, j), then zeroed on unoccupied tiles."""
    T = BAND_TILE
    M = PB // T
    out = gT.new_zeros((M, T, 6, 2, T, 6))
    s = torch.nonzero(iru >= 0).flatten()
    r, c = iru[s].long(), icu[s].long()
    blocks = gT[:, s].T.reshape(-1, 6, 6)  # [n, i, j] = gT[i*6+j, slot]
    k = r // T
    e = c // T - k
    up = (e >= 0) & (e <= 1)
    out[k[up], (r % T)[up], :, e[up], (c % T)[up], :] = -blocks[up]
    mir = (r != c) & (r // T == c // T)
    out[(c // T)[mir], (c % T)[mir], :, 0, (r % T)[mir], :] = -blocks[mir].transpose(1, 2)
    p = torch.arange(PB, device=gT.device)
    out[p // T, p % T, :, 0, p % T, :] += dbT.T.reshape(PB, 6, 6)
    occ = (occ_band.reshape(M, 2) > 0)[:, None, None, :, None, None]
    out = torch.where(occ, out, torch.zeros((), dtype=out.dtype, device=out.device))
    return out.reshape(M * 6 * T, 12 * T)


BAND_THREADS = 192  # threads a block of compact_to_band_kernel and compact_to_dense_kernel


def compact_to_band_launch(PB: int, dtype: torch.dtype = torch.float32) -> dict:
    """``compact_to_band_kernel``'s launch for ``dtype``: a ``grid`` of one
    block per (pose row, tile column), ``threads`` a block and its static
    ``smem`` (the [6, 384] strip of values and the row's 64 table entries)."""
    return dict(grid=[PB, 2], threads=BAND_THREADS,
                smem=dtype.itemsize * 6 * 6 * BAND_TILE + 4 * BAND_TILE)


def compact_to_band(gT, iru, icu, dbT, occ_band, PB: int, Wg: int, *,
                    table: Optional[torch.Tensor] = None):
    """Block-tridiagonal storage from the band-major compact Schur table
    (cuba_tpu segmm.compact_to_band): tile (k, e) of the [M*384, 768]
    output is the 384x384 block A[k, k+e] of the damped Schur complement,
    diag - (upper + mirrored blocks); unoccupied tiles are zero.  dbT
    [36, PB] is indexed by the global pose block.  ``table`` is
    :func:`band_table` of (iru, icu), built once per structure; the kernel
    needs it."""
    with trace.span("k.compact_to_band"):
        if PB % BAND_TILE != 0:
            raise ValueError(f"PB={PB} is not a multiple of {BAND_TILE}")
        M = PB // BAND_TILE
        if (tuple(gT.shape) != (36, M * Wg) or tuple(dbT.shape) != (36, PB)
                or tuple(occ_band.shape) != (2 * M,) or tuple(iru.shape) != (M * Wg,)
                or tuple(icu.shape) != (M * Wg,)):
            raise ValueError(f"gT {tuple(gT.shape)}, iru {tuple(iru.shape)}, icu "
                             f"{tuple(icu.shape)}, dbT {tuple(dbT.shape)}, occ_band "
                             f"{tuple(occ_band.shape)} do not fit PB={PB}, Wg={Wg}")
        if not cudalib.use_kernel(gT, iru, icu, dbT, occ_band):
            return compact_to_band_plain(gT, iru, icu, dbT, occ_band, PB, Wg)
        dt = cudalib.float_dtype(gT, dbT)
        cudalib.check(gT, "gT", dt, 2)
        cudalib.check(dbT, "dbT", dt, 2)
        cudalib.check(occ_band, "occ_band", torch.int32, 1)
        if table is None:
            raise ValueError("compact_to_band: the kernel needs table=band_table(iru, icu, PB)")
        cudalib.check(table, "table", torch.int32, 2)
        if tuple(table.shape) != (PB, 2 * BAND_TILE) or table.device != gT.device:
            raise ValueError(f"table {tuple(table.shape)} does not fit PB={PB}")
        cudalib.check_int32("compact_to_band", M * 6 * BAND_TILE * 12 * BAND_TILE, gT.numel())
        out = torch.empty((M * 6 * BAND_TILE, 12 * BAND_TILE), dtype=dt, device=gT.device)
        cudalib.call("compact_to_band", gT, _entry("cuba_compact_to_band", dt),
                     gT.data_ptr(), gT.shape[1], table.data_ptr(), dbT.data_ptr(), PB,
                     occ_band.data_ptr(), M, out.data_ptr())
        cudalib.count("compact_to_band", dt)
        return out


DENSE_TILE_P, DENSE_TILE_Q = 64, 128  # compact_to_dense's occupancy tiles, pose blocks


def compact_to_dense_plain(gT, iru, icu, dbT, occ2, PB: int, Wg: int):
    """Plain torch compact_to_dense: uppers, transposed mirrors and the
    damped diagonal placed into [PB, 6, PB, 6] = element (pose row, i, pose
    col, j), then zeroed on unoccupied 64x128-block tiles."""
    out = gT.new_zeros((PB, 6, PB, 6))
    s = torch.nonzero(iru >= 0).flatten()
    r, c = iru[s].long(), icu[s].long()
    blocks = gT[:, s].T.reshape(-1, 6, 6)  # [n, i, j] = gT[i*6+j, slot]
    out[r, :, c, :] = -blocks
    mir = r != c
    out[c[mir], :, r[mir], :] = -blocks[mir].transpose(1, 2)
    p = torch.arange(PB, device=gT.device)
    out[p, :, p, :] += dbT.T.reshape(PB, 6, 6)
    occ = occ2.reshape(PB // DENSE_TILE_P, PB // DENSE_TILE_Q) > 0
    occ = occ.repeat_interleave(DENSE_TILE_P, 0).repeat_interleave(DENSE_TILE_Q, 1)
    out = torch.where(occ[:, None, :, None], out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    return out.reshape(6 * PB, 6 * PB)


def compact_to_dense_launch(PB: int, dtype: torch.dtype = torch.float32) -> dict:
    """``compact_to_dense_kernel``'s launch for ``dtype``: a ``grid`` of one
    block per (pose row, column tile of DENSE_TILE_Q pose blocks),
    ``threads`` a block and its static ``smem`` (the [6, 768] strip of
    values and the tile's 128 table entries)."""
    return dict(grid=[PB, PB // DENSE_TILE_Q], threads=BAND_THREADS,
                smem=dtype.itemsize * 6 * 6 * DENSE_TILE_Q + 4 * DENSE_TILE_Q)


def compact_to_dense(gT, iru, icu, dbT, occ2, PB: int, Wg: int, *,
                     table: Optional[torch.Tensor] = None):
    """The dense damped Schur matrix [6PB, 6PB] from the band-major compact
    Schur table (cuba_tpu segmm.compact_to_dense): element (6p+i, 6q+j) is
    diag - (upper + mirrored blocks), where the diagonal is dbT [36, PB]
    (indexed by pose block) on p == q; 64x128-block tiles that occ2
    [PB/64 * PB/128] marks empty are zero.  ``table`` is :func:`dense_table`
    of (iru, icu), built once per structure; the kernel needs it
    (:func:`compact_to_dense_launch`, ``walks.compact_to_dense_walk``)."""
    with trace.span("k.compact_to_dense"):
        if PB % DENSE_TILE_Q != 0:
            raise ValueError(f"PB={PB} is not a multiple of {DENSE_TILE_Q}")
        M = PB // BAND_TILE
        n_occ = (PB // DENSE_TILE_P) * (PB // DENSE_TILE_Q)
        if (tuple(gT.shape) != (36, M * Wg) or tuple(dbT.shape) != (36, PB)
                or tuple(occ2.shape) != (n_occ,) or tuple(iru.shape) != (M * Wg,)
                or tuple(icu.shape) != (M * Wg,)):
            raise ValueError(f"gT {tuple(gT.shape)}, iru {tuple(iru.shape)}, icu "
                             f"{tuple(icu.shape)}, dbT {tuple(dbT.shape)}, occ2 "
                             f"{tuple(occ2.shape)} do not fit PB={PB}, Wg={Wg}")
        if not cudalib.use_kernel(gT, iru, icu, dbT, occ2):
            return compact_to_dense_plain(gT, iru, icu, dbT, occ2, PB, Wg)
        dt = cudalib.float_dtype(gT, dbT)
        cudalib.check(gT, "gT", dt, 2)
        cudalib.check(dbT, "dbT", dt, 2)
        cudalib.check(occ2, "occ2", torch.int32, 1)
        if table is None:
            raise ValueError("compact_to_dense: the kernel needs table=dense_table(iru, icu, PB)")
        cudalib.check(table, "table", torch.int32, 2)
        if tuple(table.shape) != (PB, PB) or table.device != gT.device:
            raise ValueError(f"table {tuple(table.shape)} does not fit PB={PB}")
        # int64 offsets of the output's rows; the table's and gT's indices int32
        cudalib.check_int32("compact_to_dense", PB * PB, gT.numel())
        out = torch.empty((6 * PB, 6 * PB), dtype=dt, device=gT.device)
        cudalib.call("compact_to_dense", gT, _entry("cuba_compact_to_dense", dt),
                     gT.data_ptr(), gT.shape[1], table.data_ptr(), dbT.data_ptr(), PB,
                     occ2.data_ptr(), out.data_ptr())
        cudalib.count("compact_to_dense", dt)
        return out


def band_transpose_plain(m4, occ, PB: int):
    """Plain torch band_transpose: the permuted copy of m4, zeroed on the
    64x128-block tiles that occ marks empty."""
    out = m4.view(6, 6, PB, PB).permute(2, 0, 3, 1).reshape(
        PB // DENSE_TILE_P, 6 * DENSE_TILE_P, PB // DENSE_TILE_Q, 6 * DENSE_TILE_Q)
    keep = occ.view(PB // DENSE_TILE_P, 1, PB // DENSE_TILE_Q, 1) > 0
    return torch.where(keep, out, torch.zeros((), dtype=m4.dtype,
                                              device=m4.device)).reshape(6 * PB, 6 * PB)


def band_transpose(m4, occ, PB: int):
    """The lane interleave of the v1 dense formation (cuba_tpu
    segmm.band_transpose): out[6p+i, 6q+j] = m4[i*6+j, p, q] for m4 [36, PB,
    PB], zero on the 64x128-block tiles that occ [PB/64 * PB/128] marks
    empty.  A copy: the kernel is bit-equal to the plain version."""
    with trace.span("k.band_transpose"):
        if PB % DENSE_TILE_Q != 0:
            raise ValueError(f"PB={PB} is not a multiple of {DENSE_TILE_Q}")
        n_occ = (PB // DENSE_TILE_P) * (PB // DENSE_TILE_Q)
        if tuple(m4.shape) != (36, PB, PB) or tuple(occ.shape) != (n_occ,):
            raise ValueError(f"m4 {tuple(m4.shape)}, occ {tuple(occ.shape)} does not fit PB={PB}")
        if not cudalib.use_kernel(m4, occ):
            return band_transpose_plain(m4, occ, PB)
        dt = cudalib.float_dtype(m4)
        cudalib.check(m4, "m4", dt, 3)
        cudalib.check(occ, "occ", torch.int32, 1)
        out = torch.empty((6 * PB, 6 * PB), dtype=dt, device=m4.device)
        cudalib.call("band_transpose", m4, _entry("cuba_band_transpose", dt),
                     m4.data_ptr(), occ.data_ptr(), PB, out.data_ptr())
        cudalib.count("band_transpose", dt)
        return out
