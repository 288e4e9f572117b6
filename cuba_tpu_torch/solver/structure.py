"""Problem compiler: graph -> static index structure (the symbolic pass).

A NumPy copy of ``cuba_tpu/solver/structure.py`` (which cannot be imported
without JAX): active/fixed vertex partitioning, the edge gather, the pose
band permutation, the landmark locality reorder, the deduplicated Hpl slot
pattern, the Schur co-observation pattern and its multiplication triplets
(and, from the C++ pass, the fused Schur chunk plan).
``tests/test_torch_structure.py`` holds every table here equal, bit for
bit, to ``cuba_tpu``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from cuba_tpu_torch import native, trace

PDIM = 6  # pose block size
LDIM = 3  # landmark block size


@dataclasses.dataclass
class EdgeArrays:
    """Per-edge SoA data for one measurement dimension (2=mono, 3=stereo)."""

    measurements: np.ndarray  # [E, mdim] float64
    omegas: np.ndarray  # [E] float64 (scalar information)
    pose_idx: np.ndarray  # [E] int32, iP in [0, total_p) (fixed poses >= num_p)
    lm_idx: np.ndarray  # [E] int32, iL in [0, total_l)

    @property
    def count(self) -> int:
        return int(self.measurements.shape[0])


@dataclasses.dataclass
class BAStructure:
    """Static problem structure produced once per initialize()."""

    num_p: int  # active (free) poses
    num_l: int  # active (free) landmarks
    total_p: int  # active + fixed poses
    total_l: int
    # initial state, gathered in internal-index order (active first)
    qs: np.ndarray  # [total_p, 4] (x,y,z,w)
    ts: np.ndarray  # [total_p, 3]
    cams: np.ndarray  # [total_p, 5]
    Xws: np.ndarray  # [total_l, 3]
    mono: EdgeArrays
    stereo: EdgeArrays
    # Hpl slots over deduplicated free (pose, landmark) pairs, sorted by
    # (landmark col, pose row)
    hpl_row: np.ndarray  # [n_hpl]
    hpl_col: np.ndarray  # [n_hpl]
    edge2hpl: np.ndarray  # [E2+E3] slot per combined edge id; n_hpl if not both-free
    # Hsc block pattern: unique upper-triangle pose pairs (r <= c), row-major
    hsc_row: np.ndarray  # [n_hsc]
    hsc_col: np.ndarray  # [n_hsc]
    # Schur multiplication triplets: Hsc[k] -= W[i] Hpl[j]^T, landmark-major
    mul_i: np.ndarray  # [n_mul] Hpl slot
    mul_j: np.ndarray  # [n_mul] Hpl slot of the same landmark
    mul_k: np.ndarray  # [n_mul] Hsc block id
    # internal edge order: internal_edges = original_edges[perm]
    mono_perm: np.ndarray  # [E2] int64
    stereo_perm: np.ndarray  # [E3] int64
    lm_rank: np.ndarray  # [num_l] int64, active-landmark renumbering (old -> new)
    pose_rank: np.ndarray = None  # [num_p] int64 band permutation, or None
    # the fused Schur chunk plan the C++ pass emits (native.symbolic_compile),
    # or None on the NumPy path; segmm.plan_schur takes it as ``precomputed``
    schur_native: tuple = None

    @property
    def n_hpl(self) -> int:
        return int(self.hpl_row.shape[0])

    @property
    def n_hsc(self) -> int:
        return int(self.hsc_row.shape[0])


def build_structure_from_arrays(
    qs, ts, cams, Xws, fixed_pose_mask, fixed_lm_mask,
    mono_p, mono_l, mono_z, mono_w,
    stereo_p, stereo_l, stereo_z, stereo_w,
) -> BAStructure:
    """Compile a problem given SoA arrays directly.

    Semantics match build_structure: active vertices first in index order,
    fixed appended after; both-fixed edges dropped.  Vertices with no edges
    are kept (they simply have empty rows).
    """
    with trace.span("structure"):
        nP, nL = qs.shape[0], Xws.shape[0]
        fixed_pose_mask = np.asarray(fixed_pose_mask, bool)
        fixed_lm_mask = np.asarray(fixed_lm_mask, bool)

        def perm_of(fixed_mask):
            order = np.concatenate([np.where(~fixed_mask)[0], np.where(fixed_mask)[0]])
            inv = np.empty_like(order)
            inv[order] = np.arange(order.size)
            return order, inv

        p_order, p_inv = perm_of(fixed_pose_mask)
        l_order, l_inv = perm_of(fixed_lm_mask)
        num_p = int((~fixed_pose_mask).sum())
        num_l = int((~fixed_lm_mask).sum())

        def gather(ep, el, ez, ew, mdim):
            ep = np.asarray(ep, np.int64)
            el = np.asarray(el, np.int64)
            keep = ~(fixed_pose_mask[ep] & fixed_lm_mask[el])
            return EdgeArrays(
                np.asarray(ez, np.float64).reshape(-1, mdim)[keep],
                np.asarray(ew, np.float64)[keep],
                p_inv[ep[keep]].astype(np.int32),
                l_inv[el[keep]].astype(np.int32),
            )

        return _finish_structure(
            num_p, num_l, nP, nL,
            np.asarray(qs, np.float64)[p_order],
            np.asarray(ts, np.float64)[p_order],
            np.asarray(cams, np.float64)[p_order],
            np.asarray(Xws, np.float64)[l_order],
            gather(mono_p, mono_l, mono_z, mono_w, 2),
            gather(stereo_p, stereo_l, stereo_z, stereo_w, 3),
        )


def build_structure(
    pose_ids_sorted: List[int],
    poses: Dict[int, object],
    lm_ids_sorted: List[int],
    landmarks: Dict[int, object],
    mono_edges,
    stereo_edges,
) -> BAStructure:
    """Compile the graph into a BAStructure.

    Vertices with no edges are skipped; active vertices get internal indices
    0..n-1 in id order, fixed ones are appended after; edges with both
    endpoints fixed are dropped.  Sets each vertex's ``iP`` / ``iL``.
    """
    with trace.span("structure"):
        active_p, fixed_p = [], []
        for pid in pose_ids_sorted:
            v = poses[pid]
            if v.edges:
                (fixed_p if v.fixed else active_p).append(v)
        active_l, fixed_l = [], []
        for lid in lm_ids_sorted:
            v = landmarks[lid]
            if v.edges:
                (fixed_l if v.fixed else active_l).append(v)

        num_p, num_l = len(active_p), len(active_l)
        all_p = active_p + fixed_p
        all_l = active_l + fixed_l
        for i, v in enumerate(all_p):
            v.iP = i
        for i, v in enumerate(all_l):
            v.iL = i

        total_p, total_l = len(all_p), len(all_l)
        qs = np.stack([v.q for v in all_p]) if total_p else np.zeros((0, 4))
        ts = np.stack([v.t for v in all_p]) if total_p else np.zeros((0, 3))
        cams = np.stack([v.camera.to_array() for v in all_p]) if total_p else np.zeros((0, 5))
        Xws = np.stack([v.Xw for v in all_l]) if total_l else np.zeros((0, 3))

        def gather(edges, mdim):
            meas, om, pi, li = [], [], [], []
            for e in edges:
                vp, vl = e.vertexP, e.vertexL
                if vp.fixed and vl.fixed:
                    continue
                meas.append(e.measurement)
                om.append(e.information)
                pi.append(vp.iP)
                li.append(vl.iL)
            if meas:
                return EdgeArrays(
                    np.asarray(meas, dtype=np.float64).reshape(-1, mdim),
                    np.asarray(om, dtype=np.float64),
                    np.asarray(pi, dtype=np.int32),
                    np.asarray(li, dtype=np.int32),
                )
            return EdgeArrays(
                np.zeros((0, mdim)), np.zeros(0), np.zeros(0, np.int32), np.zeros(0, np.int32)
            )

        s = _finish_structure(num_p, num_l, total_p, total_l, qs, ts, cams, Xws,
                              gather(mono_edges, 2), gather(stereo_edges, 3))
        # the symbolic pass renumbers active landmarks (and maybe active poses):
        # keep the vertices' internal indices in step so write-back hits their rows
        for v in active_l:
            v.iL = int(s.lm_rank[v.iL])
        if s.pose_rank is not None:
            for v in active_p:
                v.iP = int(s.pose_rank[v.iP])
        return s


def _pose_band_perm(num_p, mono: EdgeArrays, stereo: EdgeArrays):
    """Bandwidth-reducing active-pose permutation (old -> new), or None.

    Folds a circular (loop-closure) pose order (0, P-1, 1, P-2, ...) into a
    band when that brings the landmark span under 64 poses and the raw
    order does not.
    """
    if num_p <= 128:
        return None
    big = np.int64(1) << 60
    lo = None
    for ec in (mono, stereo):
        pi = np.asarray(ec.pose_idx, np.int64)
        li = np.asarray(ec.lm_idx, np.int64)
        m = pi < num_p
        if not m.any():
            continue
        if lo is None:
            n_lm = int(li.max()) + 1
            lo = np.full(n_lm, big)
            hi = np.full(n_lm, -1, np.int64)
        elif int(li.max()) >= lo.size:
            pad = int(li.max()) + 1 - lo.size
            lo = np.concatenate([lo, np.full(pad, big)])
            hi = np.concatenate([hi, np.full(pad, -1, np.int64)])
        np.minimum.at(lo, li[m], pi[m])
        np.maximum.at(hi, li[m], pi[m])
    if lo is None:
        return None
    seen = hi >= 0
    if not seen.any():
        return None
    bw0 = int((hi[seen] - lo[seen]).max())
    if bw0 <= 64:
        return None
    ids = np.arange(num_p, dtype=np.int64)
    fold = np.minimum(2 * ids, 2 * (num_p - 1 - ids) + 1)
    flo = np.full(lo.size, big)
    fhi = np.full(hi.size, -1, np.int64)
    for ec in (mono, stereo):
        pi = np.asarray(ec.pose_idx, np.int64)
        li = np.asarray(ec.lm_idx, np.int64)
        m = pi < num_p
        if m.any():
            fp = fold[pi[m]]
            np.minimum.at(flo, li[m], fp)
            np.maximum.at(fhi, li[m], fp)
    bw1 = int((fhi[seen] - flo[seen]).max())
    if bw1 <= 64 and bw1 < bw0:
        return fold.astype(np.int64)
    return None


def _locality_reorder(num_l, mono: EdgeArrays, stereo: EdgeArrays, Xws):
    """Renumber active landmarks by their min observing pose and sort each
    edge type by (new landmark, pose).  Returns
    (rank[num_l], mono, mono_perm, stereo, stereo_perm, Xws)."""
    total_p = int(max(mono.pose_idx.max(initial=-1), stereo.pose_idx.max(initial=-1)) + 1)
    total_l = int(max(mono.lm_idx.max(initial=-1), stereo.lm_idx.max(initial=-1),
                      num_l - 1) + 1)
    nat = native.locality_reorder(
        mono.pose_idx, mono.lm_idx, stereo.pose_idx, stereo.lm_idx,
        max(total_p, 1), max(total_l, 1), num_l,
    )
    if nat is not None:
        rank, mono_perm, stereo_perm, mono_new_li, stereo_new_li = nat

        def apply(ec: EdgeArrays, perm, new_li):
            return EdgeArrays(ec.measurements[perm], ec.omegas[perm], ec.pose_idx[perm], new_li)

        Xws = Xws.copy()
        Xws[np.asarray(rank, np.int64)] = Xws[:num_l].copy()
        return (rank, apply(mono, mono_perm, mono_new_li), mono_perm,
                apply(stereo, stereo_perm, stereo_new_li), stereo_perm, Xws)
    minp = np.full(num_l, np.int64(1) << 60, np.int64)
    for ec in (mono, stereo):
        li = np.asarray(ec.lm_idx, np.int64)
        m = li < num_l
        if m.any():
            np.minimum.at(minp, li[m], np.asarray(ec.pose_idx, np.int64)[m])
    order = np.argsort(minp, kind="stable")  # new -> old
    rank = np.empty(num_l, np.int64)
    rank[order] = np.arange(num_l)

    def remap_sort(ec: EdgeArrays):
        li = np.asarray(ec.lm_idx, np.int64)
        new_li = np.where(li < num_l, rank[np.minimum(li, max(num_l - 1, 0))], li)
        perm = np.lexsort((ec.pose_idx, new_li))
        return EdgeArrays(ec.measurements[perm], ec.omegas[perm], ec.pose_idx[perm],
                          new_li[perm].astype(np.int32)), perm

    mono2, mono_perm = remap_sort(mono)
    stereo2, stereo_perm = remap_sort(stereo)
    Xws = Xws.copy()
    Xws[:num_l] = Xws[:num_l][order]
    return rank, mono2, mono_perm, stereo2, stereo_perm, Xws


def _pair_expand(col_ptr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """All within-segment slot pairs (i, j), i <= j, of a CSC column
    pointer, in column-major generation order."""
    seg_len = np.diff(col_ptr)
    n_slots = int(col_ptr[-1])
    if n_slots == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    col_of_slot = np.repeat(np.arange(seg_len.size), seg_len)
    rank = np.arange(n_slots) - col_ptr[col_of_slot]
    # slot s pairs with slots s .. end of its column
    counts = seg_len[col_of_slot] - rank
    i_idx = np.repeat(np.arange(n_slots), counts)
    offsets = np.arange(counts.sum()) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    return i_idx, i_idx + offsets


def _symbolic_numpy(e_pi, e_li, num_p, num_l, total_p):
    """NumPy twin of the C++ symbolic pass: (hpl_row, hpl_col, edge2hpl,
    hsc_row, hsc_col, mul_i, mul_j, mul_k, None)."""
    both_free = (e_pi < num_p) & (e_li < num_l)
    pair_key = e_li.astype(np.int64) * max(total_p, 1) + e_pi.astype(np.int64)
    uniq_keys, inv = np.unique(pair_key[both_free], return_inverse=True)
    n_hpl = uniq_keys.size
    hpl_col = (uniq_keys // max(total_p, 1)).astype(np.int32)
    hpl_row = (uniq_keys % max(total_p, 1)).astype(np.int32)
    edge2hpl = np.full(e_pi.size, n_hpl, dtype=np.int32)  # n_hpl == "no slot"
    edge2hpl[both_free] = inv.astype(np.int32)

    col_ptr = np.zeros(num_l + 1, dtype=np.int64)
    if n_hpl:
        np.add.at(col_ptr, hpl_col + 1, 1)
        np.cumsum(col_ptr, out=col_ptr)
    i_idx, j_idx = _pair_expand(col_ptr)
    if i_idx.size:
        r1 = hpl_row[i_idx].astype(np.int64)
        r2 = hpl_row[j_idx].astype(np.int64)
        # r1 <= r2 within a (pose-)sorted column; np.unique sorts the keys,
        # so mul_k is the row-major rank of the Hsc block
        uniq_blk, mul_k = np.unique(r1 * max(num_p, 1) + r2, return_inverse=True)
        hsc_row = (uniq_blk // max(num_p, 1)).astype(np.int32)
        hsc_col = (uniq_blk % max(num_p, 1)).astype(np.int32)
        mul_i, mul_j, mul_k = (a.astype(np.int32) for a in (i_idx, j_idx, mul_k))
    else:
        hsc_row = hsc_col = np.zeros(0, dtype=np.int32)
        mul_i = mul_j = mul_k = np.zeros(0, dtype=np.int32)
    return hpl_row, hpl_col, edge2hpl, hsc_row, hsc_col, mul_i, mul_j, mul_k, None


def _finish_structure(num_p, num_l, total_p, total_l, qs, ts, cams, Xws,
                      mono: EdgeArrays, stereo: EdgeArrays) -> BAStructure:
    """Shared symbolic pass: pose band permutation, landmark locality
    reorder, the Hpl slot pattern, the Hsc pattern and the Schur triplets
    (C++ when built, else NumPy)."""
    with trace.span("structure.band_perm"):
        pose_rank = _pose_band_perm(num_p, mono, stereo)
    if pose_rank is not None:
        order = np.argsort(pose_rank)  # new -> old
        qs, ts, cams = qs.copy(), ts.copy(), cams.copy()
        qs[:num_p] = qs[:num_p][order]
        ts[:num_p] = ts[:num_p][order]
        cams[:num_p] = cams[:num_p][order]

        def remap_poses(ec: EdgeArrays) -> EdgeArrays:
            pi = np.asarray(ec.pose_idx, np.int64)
            new = np.where(pi < num_p, pose_rank[np.minimum(pi, max(num_p - 1, 0))], pi)
            return EdgeArrays(ec.measurements, ec.omegas, new.astype(np.int32), ec.lm_idx)

        mono = remap_poses(mono)
        stereo = remap_poses(stereo)
    if num_l:
        with trace.span("structure.locality"):
            lm_rank, mono, mono_perm, stereo, stereo_perm, Xws = _locality_reorder(
                num_l, mono, stereo, Xws
            )
    else:
        lm_rank = np.zeros(0, np.int64)
        mono_perm = np.arange(mono.count, dtype=np.int64)
        stereo_perm = np.arange(stereo.count, dtype=np.int64)

    e_pi = np.concatenate([mono.pose_idx, stereo.pose_idx])
    e_li = np.concatenate([mono.lm_idx, stereo.lm_idx])
    with trace.span("structure.symbolic"):
        sym = native.symbolic_compile(e_pi, e_li, num_p, num_l)
        if sym is None:
            sym = _symbolic_numpy(e_pi, e_li, num_p, num_l, total_p)
    hpl_row, hpl_col, edge2hpl, hsc_row, hsc_col, mul_i, mul_j, mul_k, schur_native = sym
    return BAStructure(
        num_p=num_p, num_l=num_l, total_p=total_p, total_l=total_l,
        qs=qs, ts=ts, cams=cams, Xws=Xws, mono=mono, stereo=stereo,
        hpl_row=hpl_row, hpl_col=hpl_col, edge2hpl=edge2hpl,
        hsc_row=hsc_row, hsc_col=hsc_col, mul_i=mul_i, mul_j=mul_j, mul_k=mul_k,
        mono_perm=mono_perm, stereo_perm=stereo_perm,
        lm_rank=lm_rank, pose_rank=pose_rank, schur_native=schur_native,
    )
