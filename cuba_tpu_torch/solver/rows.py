"""The rows front end, the matrix-free PCG reduced solve and the v1 and v2
Schur formations (port of ``cuba_tpu/solver/mxu.py``), over transposed
``[D, N]`` tensors.

Every index-driven step goes through the wrappers of ``ops/segmm.py``
(hand-written CUDA kernels on the card): each gather is ``segmm.gather``,
each segment sum ``segmm.segsum``.  The Schur factors of
:func:`prepare_factors` are two more on the card (``ops/factors.py``: the
landmarks' damped fp64 3x3 inverses, and each slot's W = Hpl Hll^-1 and W
bl), dispatched by :func:`hll_inverse_rows` and :func:`slot_factors_rows`;
the rest of the per-slot 6x6/3x3 block algebra is reshapes and einsums.
Function by function:

=========================  ==================================
this module                ``cuba_tpu/solver/mxu.py``
=========================  ==================================
``plan_rows``              ``plan_mxu(wire_pack=False)`` (688-1116) and
                           ``plan_schur_for`` (306)
``plan_row_tables``        ``plan_mxu``'s host half
``edge_rows``              ``edge_rows_mxu`` (1428)
``build_system_rows``      ``build_system_rows`` (1488)
``_sym3x3_inv_rows``       ``_sym3x3_inv_rows`` (1548)
``hll_inverse_rows``       ``prepare_factors_mxu``'s damped inverse
``slot_factors_rows``      ``prepare_factors_mxu``'s W and W bl einsums
``prepare_factors``        ``prepare_factors_mxu`` (1575)
``schur_band``             ``schur_band_mxu`` (1676)
``schur_compact``          ``schur_compact_mxu`` (1698)
``band_from_compact``      ``band_from_compact`` (1733)
``schur_dense``            ``schur_dense_mxu`` (1620-1673), both branches
``dense_from_compact``     ``dense_from_compact`` (1719)
``back_substitute``        ``back_substitute_mxu`` (1757)
``_hpp_matvec_rows``       ``_hpp_matvec_rows`` (1778)
``schur_matvec_rows``      ``schur_matvec_rows`` (1786)
``schur_block_diag_inv``   ``schur_block_diag_inv_rows`` (1822)
``pcg_solve_rows``         ``pcg_solve_rows`` (1839)
``max_diagonal_T``         ``max_diagonal_T`` (1904)
=========================  ==================================

The planner plans for the card.  It takes every structure with poses,
landmarks and Hpl slots whose ``schur_fused`` chunk plan holds where a Schur
formation is needed (that plan is the kernel's shared-memory window): the
v2 band-major formation where the structure has Hsc blocks and its fullest
64-row band holds at most ``_WG_MAX`` of them, else the v1 formation (two
combines into the dense block table [36, PB*PB] and ``band_transpose``).
Elsewhere (pose-only and landmark-only structures, no Hpl slot, a chunk
plan that fails) it finds no plan and the engine takes the AoS path
(``solver/assembly.py``).  The paddings are the card's: each per-edge and
per-slot table to a multiple of 1024.

Table layouts: HppT [42, P] (Hpp row-major 36, then bp 6), HllT [12, L]
(Hll 9, then bl 3), HplT [18, hpl_pad] (Hpl row-major i*3+k per slot),
gT [36, M*Wg] (the band-major compact Schur table: band m holds the
(row, col)-sorted Hsc blocks whose row lies in [64m, 64(m+1)), at lanes
[m*Wg, m*Wg + count_m)).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cuba_tpu_torch import trace
from cuba_tpu_torch.ops import cudalib, factors, segmm
from cuba_tpu_torch.ops.segmm import SegmentCSR
from cuba_tpu_torch.solver import comm, edgerows
from cuba_tpu_torch.solver.structure import BAStructure


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# band-major lanes per 64-row band at most (cuba_tpu mxu._WG_MAX, the TPU's
# VMEM bound, kept here to choose between v2 and v1); above it the v2
# formation does not plan.  Read at call time, as plan_mxu does.
_WG_MAX = 2048
# perm36[i*6+j] = j*6+i: row (i, j) of a mirrored block is row (j, i) of its
# upper block
_PERM36 = np.arange(36).reshape(6, 6).T.reshape(-1)


def _pad_ids(ids, n, valid_mask=None):
    """-1-padded int32 table of ``ids``."""
    out = np.full(n, -1, np.int32)
    v = np.asarray(ids, np.int32)
    out[: v.size] = v if valid_mask is None else np.where(valid_mask, v, np.int32(-1))
    return out


@dataclasses.dataclass
class RowPlan:
    """Host plan of one structure: its paddings and its Schur formation."""

    e_pad_m: int  # per-edge tables: max(round_up(E, 1024), 1024)
    e_pad_s: int
    hpl_pad: int  # per-slot tables: round_up(n_hpl, 1024), at least schur_fused's window
    # the Schur formations (None / 0 without need_dense)
    pad_blocks: int = 0  # PB: the reduced system in pose blocks
    schur: Optional[segmm.SchurPlan] = None
    v2: bool = False  # the band-major formation; else v1 (with need_dense)
    wg: int = 0  # v2: band-major lanes per 64-row band
    lr_k: int = 0  # v2 band + low rank: loop-column pose blocks |J|
    lr_nob: int = 0  # and out-of-band blocks


@dataclasses.dataclass
class RowConsts:
    """Device tables of one structure (int32 ids, -1 on padding)."""

    measT_m: torch.Tensor  # [2, e_pad_m]
    measT_s: torch.Tensor  # [3, e_pad_s]
    omegaT_m: torch.Tensor  # [e_pad_m], 0 on padding
    omegaT_s: torch.Tensor
    pose_gid_m: torch.Tensor  # ungated vertex ids per edge
    pose_gid_s: torch.Tensor
    lm_gid_m: torch.Tensor
    lm_gid_s: torch.Tensor
    pose_acc_m: torch.Tensor  # gated ids (-1 on a fixed endpoint)
    pose_acc_s: torch.Tensor
    lm_acc_m: torch.Tensor
    lm_acc_s: torch.Tensor
    e2h_m: torch.Tensor  # Hpl slot per edge
    e2h_s: torch.Tensor
    hpl_row: torch.Tensor  # [hpl_pad]
    hpl_col: torch.Tensor
    # the fixed summation order of every segment-sum call site
    csr_pose_m: SegmentCSR
    csr_pose_s: SegmentCSR
    csr_lm_m: SegmentCSR
    csr_lm_s: SegmentCSR
    csr_e2h_m: SegmentCSR
    csr_e2h_s: SegmentCSR
    csr_hpl_row: SegmentCSR
    csr_hpl_col: SegmentCSR
    # the Schur formations (None without need_dense)
    sc_sb: Optional[torch.Tensor] = None  # [C] schur_fused slot blocks
    sc_li: Optional[torch.Tensor] = None  # [C*chunk] local ids
    sc_lj: Optional[torch.Tensor] = None
    sc_lk: Optional[torch.Tensor] = None
    gkey_up2: Optional[torch.Tensor] = None  # [C*kwin] band slot per output lane
    iru: Optional[torch.Tensor] = None  # [M*Wg] block row / col per band slot
    icu: Optional[torch.Tensor] = None
    band_occ: Optional[torch.Tensor] = None  # [2M] tile (k, e) occupancy
    band_table: Optional[torch.Tensor] = None  # [PB, 128] segmm.band_table
    occ2: Optional[torch.Tensor] = None  # [PB/64 * PB/128] dense tile occupancy
    dense_table: Optional[torch.Tensor] = None  # [PB, PB] segmm.dense_table (dense only)
    csr_sc: Optional[SegmentCSR] = None  # schur_fused's per-lane order and pair table
    csr_up2: Optional[SegmentCSR] = None  # the combine's order
    # v2 band + low rank: the out-of-band blocks' band slots (their loop
    # columns are the engine's, from band_cr.loop_plan)
    ob_rkey: Optional[torch.Tensor] = None  # [n_ob] band slot per out-of-band block
    # v1 formation: dense block keys of the upper and the mirrored blocks
    gkey_up: Optional[torch.Tensor] = None  # [C*kwin] r*PB + c per window lane
    gkey_lo: Optional[torch.Tensor] = None  # [C*kwin] c*PB + r off the diagonal
    occ: Optional[torch.Tensor] = None  # [PB/64 * PB/128] band_transpose's tiles
    csr_up: Optional[SegmentCSR] = None
    csr_lo: Optional[SegmentCSR] = None


def pad_blocks_of(num_p: int, pad: int = 128) -> int:
    """The reduced system's padding in pose blocks (cuba_tpu
    engine._pad_blocks, BAConfig.pose_block_pad)."""
    if pad % 128 != 0 or pad <= 0:
        raise ValueError(f"pose_block_pad must be a positive multiple of 128, got {pad}")
    return max(((num_p + pad - 1) // pad) * pad, pad)


def plan_schur_for(s: BAStructure) -> segmm.SchurPlan:
    """schur_fused's chunk plan: the C++ pass's when its geometry matches,
    else planned here."""
    chunk, sb, mk = segmm.SC_GEOMETRY
    return segmm.plan_schur(s.mul_i, s.mul_j, s.mul_k, s.n_hpl, s.n_hsc, chunk=chunk,
                            slot_block=sb, max_kwin=mk, precomputed=s.schur_native,
                            col=s.hpl_col)


def _band_tables(s: BAStructure, sc: segmm.SchurPlan, PB: int, lr=None):
    """The v2 band-major tables of ``plan_mxu``'s need_dense branch: (wg,
    {gkey_up2, iru, icu, occ2, band_occ} and, with the loop plan ``lr`` of a
    band with loop closures, the out-of-band blocks' band slots
    {ob_rkey}), or None where the v1 formation takes the structure (Wg over
    _WG_MAX or no Hsc block)."""
    i32 = np.int32
    n_hsc = s.n_hsc
    gid = sc.gid.astype(np.int64)
    hr = np.asarray(s.hsc_row, np.int64)
    hc = np.asarray(s.hsc_col, np.int64)
    M = PB // 64
    bandcnt = np.bincount(hr // 64, minlength=M)
    wg = _round_up(max(int(bandcnt.max()) if n_hsc else 1, 1), 128)
    if wg > _WG_MAX or not n_hsc:
        return None
    # blocks are (row, col)-sorted: the position within a band is the slot
    bandstart = np.zeros(M + 1, np.int64)
    np.cumsum(bandcnt, out=bandstart[1:])
    bslot = (hr // 64) * wg + (np.arange(n_hsc, dtype=np.int64) - bandstart[hr // 64])
    gkey_up2 = np.where(gid >= 0, bslot[np.maximum(gid, 0)], -1).astype(i32)
    iru = np.full(M * wg, -1, i32)
    icu = np.full(M * wg, -1, i32)
    iru[bslot] = hr
    icu[bslot] = hc
    # compact_to_dense's 64x128-block tiles holding an upper, a mirror or
    # the diagonal
    occ2 = np.zeros((PB // 64, PB // 128), i32)
    occ2[hr // 64, hc // 128] = 1
    occ2[hc // 64, hr // 128] = 1
    dd = np.arange(PB)
    occ2[dd // 64, dd // 128] = 1
    # D_k always carries the damped diagonal; U_k only with adjacent blocks
    band_occ = np.zeros(M * 2, i32)
    band_occ[0::2] = 1
    tr, tc = hr // 64, hc // 64
    adj = np.abs(tr - tc) == 1
    if adj.any():
        band_occ[np.minimum(tr[adj], tc[adj]) * 2 + 1] = 1
    tables = dict(gkey_up2=gkey_up2, iru=iru, icu=icu, occ2=occ2.reshape(-1),
                  band_occ=band_occ)
    if lr is not None:
        tables["ob_rkey"] = bslot[lr["ob_idx"]].astype(i32)
    return wg, tables


def _v1_tables(s: BAStructure, sc: segmm.SchurPlan, PB: int):
    """The v1 dense-key tables of ``plan_mxu``'s ``if not v2`` branch:
    {gkey_up, gkey_lo, occ}."""
    i32 = np.int32
    gid = sc.gid.astype(np.int64)
    hr = np.asarray(s.hsc_row, np.int64)
    hc = np.asarray(s.hsc_col, np.int64)
    r = np.where(gid >= 0, hr[np.maximum(gid, 0)], 0)
    c = np.where(gid >= 0, hc[np.maximum(gid, 0)], 0)
    gkey_up = np.where(gid >= 0, r * PB + c, -1).astype(i32)
    gkey_lo = np.where((gid >= 0) & (r != c), c * PB + r, -1).astype(i32)
    # 64x128-block tiles holding any dense block (uppers, mirrors, and the
    # diagonal including the padding poses)
    occ = np.zeros((PB // 64, PB // 128), i32)
    v = gid >= 0
    occ[r[v] // 64, c[v] // 128] = 1
    occ[c[v] // 64, r[v] // 128] = 1
    dd = np.arange(PB)
    occ[dd // 64, dd // 128] = 1
    return dict(gkey_up=gkey_up, gkey_lo=gkey_lo, occ=occ.reshape(-1))


def plan_row_tables(s: BAStructure, pad_blocks: int = 0, lr=None):
    """The host half of :func:`plan_rows`: (RowPlan, {name: np.ndarray}),
    or (None, None) where the rows front end does not take the structure
    (no pose, landmark or Hpl slot, or with ``pad_blocks`` a ``schur_fused``
    chunk plan that does not hold).  The id tables are ``plan_mxu``'s on
    their valid prefix and -1 beyond it; with ``pad_blocks`` the Schur
    formation's tables come too (v2 where it plans, else v1), and with the
    structure's loop plan ``lr`` (``band_cr.loop_plan``) v2's out-of-band
    tables."""
    num_p, num_l, n_hpl = s.num_p, s.num_l, s.n_hpl
    if num_p == 0 or num_l == 0 or n_hpl == 0:
        return None, None
    need_dense = pad_blocks > 0
    sc = None
    if need_dense:
        if pad_blocks % 128 != 0:
            raise ValueError(f"pad_blocks must be a positive multiple of 128, got {pad_blocks}")
        sc = plan_schur_for(s)
        if not sc.ok:
            return None, None
    Em, Es = s.mono.count, s.stereo.count
    e_pad_m = max(_round_up(Em, 1024), 1024)
    e_pad_s = max(_round_up(Es, 1024), 1024)
    # schur_fused reads W/Hpl windows up to the plan's padded slot count
    hpl_pad = max(_round_up(n_hpl, 1024), sc.n_slot_pad if sc else 1024)
    tables = dict(
        pose_gid_m=_pad_ids(s.mono.pose_idx, e_pad_m),
        pose_gid_s=_pad_ids(s.stereo.pose_idx, e_pad_s),
        lm_gid_m=_pad_ids(s.mono.lm_idx, e_pad_m),
        lm_gid_s=_pad_ids(s.stereo.lm_idx, e_pad_s),
        pose_acc_m=_pad_ids(s.mono.pose_idx, e_pad_m, s.mono.pose_idx < num_p),
        pose_acc_s=_pad_ids(s.stereo.pose_idx, e_pad_s, s.stereo.pose_idx < num_p),
        lm_acc_m=_pad_ids(s.mono.lm_idx, e_pad_m, s.mono.lm_idx < num_l),
        lm_acc_s=_pad_ids(s.stereo.lm_idx, e_pad_s, s.stereo.lm_idx < num_l),
        e2h_m=_pad_ids(s.edge2hpl[:Em], e_pad_m, s.edge2hpl[:Em] < n_hpl),
        e2h_s=_pad_ids(s.edge2hpl[Em:], e_pad_s, s.edge2hpl[Em:] < n_hpl),
        hpl_row=_pad_ids(s.hpl_row, hpl_pad),
        hpl_col=_pad_ids(s.hpl_col, hpl_pad),
    )
    plan = RowPlan(e_pad_m, e_pad_s, hpl_pad)
    if not need_dense:
        return plan, tables
    v2 = _band_tables(s, sc, pad_blocks, lr)
    if v2 is not None:
        plan.v2, (plan.wg, form) = True, v2
        if lr is not None:
            plan.lr_k, plan.lr_nob = lr["jrows"].size // 6, lr["ob_idx"].size
    else:
        form = _v1_tables(s, sc, pad_blocks)
    tables.update(form, sc_sb=np.asarray(sc.sb, np.int32), sc_li=np.asarray(sc.li, np.int32),
                  sc_lj=np.asarray(sc.lj, np.int32), sc_lk=np.asarray(sc.lk, np.int32))
    plan.pad_blocks, plan.schur = pad_blocks, sc
    return plan, tables


def plan_rows(s: BAStructure, device, dtype, pad_blocks: int = 0, dense: bool = False,
              lr=None):
    """Plan a structure and upload its tables: (RowPlan, RowConsts), or
    (None, None) where :func:`plan_row_tables` finds no plan.  With
    ``pad_blocks`` the Schur formation's tables and CSRs come too: for v2
    the band placement table, with ``dense`` the dense one and with the
    loop plan ``lr`` the out-of-band blocks' slots; for v1 the two
    combines' keys and CSRs and ``band_transpose``'s occupancy."""
    with trace.span("plan.row_tables"):
        plan, t = plan_row_tables(s, pad_blocks, lr)
    if plan is None:
        return None, None
    Em, Es = s.mono.count, s.stereo.count
    measT_m = np.zeros((2, plan.e_pad_m))
    measT_m[:, :Em] = s.mono.measurements.T
    measT_s = np.zeros((3, plan.e_pad_s))
    measT_s[:, :Es] = s.stereo.measurements.T
    omegaT_m = np.zeros(plan.e_pad_m)
    omegaT_m[:Em] = s.mono.omegas
    omegaT_s = np.zeros(plan.e_pad_s)
    omegaT_s[:Es] = s.stereo.omegas

    def up(a, dt=None):
        with trace.span("engine.upload"):
            return torch.as_tensor(a, dtype=dt, device=device)

    def ints(name):
        return up(t[name]) if name in t else None

    def floats(a):
        return up(a, dtype)

    def csr(name, num_out):
        return segmm.segment_csr(t[name], num_out, device)

    consts = RowConsts(
        measT_m=floats(measT_m), measT_s=floats(measT_s),
        omegaT_m=floats(omegaT_m), omegaT_s=floats(omegaT_s),
        **{name: ints(name) for name in (
            "pose_gid_m", "pose_gid_s", "lm_gid_m", "lm_gid_s",
            "pose_acc_m", "pose_acc_s", "lm_acc_m", "lm_acc_s",
            "e2h_m", "e2h_s", "hpl_row", "hpl_col")},
        csr_pose_m=csr("pose_acc_m", s.num_p), csr_pose_s=csr("pose_acc_s", s.num_p),
        csr_lm_m=csr("lm_acc_m", s.num_l), csr_lm_s=csr("lm_acc_s", s.num_l),
        csr_e2h_m=csr("e2h_m", plan.hpl_pad), csr_e2h_s=csr("e2h_s", plan.hpl_pad),
        csr_hpl_row=csr("hpl_row", s.num_p), csr_hpl_col=csr("hpl_col", s.num_l),
    )
    if plan.schur is None:
        return plan, consts
    PB, sc = plan.pad_blocks, plan.schur
    with trace.span("plan.schur_lane_csr"):
        csr_sc = segmm.schur_lane_csr(sc, device)
    consts = dataclasses.replace(
        consts, **{name: ints(name) for name in ("sc_sb", "sc_li", "sc_lj", "sc_lk")},
        csr_sc=csr_sc)
    if plan.v2:
        consts = dataclasses.replace(
            consts, **{name: ints(name) for name in (
                "gkey_up2", "iru", "icu", "band_occ", "occ2", "ob_rkey")},
            band_table=up(segmm.band_table(t["iru"], t["icu"], PB)),
            csr_up2=csr("gkey_up2", PB // 64 * plan.wg),
        )
        if dense:
            consts.dense_table = up(segmm.dense_table(t["iru"], t["icu"], PB))
        return plan, consts
    consts = dataclasses.replace(
        consts, **{name: ints(name) for name in ("gkey_up", "gkey_lo", "occ")},
        csr_up=csr("gkey_up", PB * PB), csr_lo=csr("gkey_lo", PB * PB),
    )
    return plan, consts


# ---------------------------------------------------------------------------
# device phases
# ---------------------------------------------------------------------------


def edge_rows(qs, ts, Xws, cams, kernels, chi_dtype, counts, rc: RowConsts):
    """Residual front end.  Returns (pack_m, pack_s, chi); pack = (g12
    [12, E], err [mdim, E], Xc [3, E], inv_z [E]), or None for an absent
    edge type."""
    psrc = torch.cat([qs, ts, cams], dim=1).T.contiguous()  # [12, total_p]
    XwT = Xws.T.contiguous()
    chi = torch.zeros((), dtype=chi_dtype, device=qs.device)
    packs = []
    for count, pgid, lgid, measT, omegaT, mdim, kern in (
        (counts[0], rc.pose_gid_m, rc.lm_gid_m, rc.measT_m, rc.omegaT_m, 2, kernels[0]),
        (counts[1], rc.pose_gid_s, rc.lm_gid_s, rc.measT_s, rc.omegaT_s, 3, kernels[1]),
    ):
        if count == 0:
            packs.append(None)
            continue
        g12 = segmm.gather(psrc, pgid)
        xw = segmm.gather(XwT, lgid)
        with trace.span("rows.edge_residuals"):
            err, Xc, inv_z = edgerows.residual_rows(g12, xw, measT, pgid >= 0, mdim)
            chi = chi + edgerows.chi_rows(err, omegaT, kern, chi_dtype)
        packs.append((g12, err, Xc, inv_z))
    return packs[0], packs[1], chi


def build_system_rows(pack_m, pack_s, kernels, num_p, num_l, plan: RowPlan, rc: RowConsts):
    """Quadratic-form assembly from the residual packs: (HppT, HllT, HplT)."""
    outs = []
    for pack, omegaT, mdim, kern, pose_ids, lm_ids, e2h, c_p, c_l, c_h in (
        (pack_m, rc.omegaT_m, 2, kernels[0], rc.pose_acc_m, rc.lm_acc_m, rc.e2h_m,
         rc.csr_pose_m, rc.csr_lm_m, rc.csr_e2h_m),
        (pack_s, rc.omegaT_s, 3, kernels[1], rc.pose_acc_s, rc.lm_acc_s, rc.e2h_s,
         rc.csr_pose_s, rc.csr_lm_s, rc.csr_e2h_s),
    ):
        if pack is None:
            continue
        g12, err, Xc, inv_z = pack
        with trace.span("rows.edge_terms"):
            v42, v12, v18 = edgerows.term_rows(g12, err, Xc, inv_z, omegaT, kern, mdim)
        HppT = segmm.segsum(v42, pose_ids, num_p, c_p)
        HllT = segmm.segsum(v12, lm_ids, num_l, c_l)
        HplT = segmm.segsum(v18, e2h, plan.hpl_pad, c_h)
        outs.append((HppT, HllT, HplT))
    if len(outs) == 1:
        return outs[0]
    return tuple(a + b for a, b in zip(outs[0], outs[1]))


def _sym3x3_inv_rows(h: torch.Tensor) -> torch.Tensor:
    """Closed-form symmetric 3x3 inverse over row-major rows [9, L], term
    for term as cuba_tpu's (reference Sym3x3Inv)."""
    a00, a01, a02 = h[0], h[1], h[2]
    a11, a12 = h[4], h[5]
    a22 = h[8]
    det = (
        a00 * a11 * a22
        + a01 * a12 * a02
        + a02 * a01 * a12
        - a00 * a12 * a12
        - a02 * a11 * a02
        - a01 * a01 * a22
    )
    inv_det = 1.0 / det
    b00 = inv_det * (a11 * a22 - a12 * a12)
    b01 = inv_det * (a02 * a12 - a01 * a22)
    b11 = inv_det * (a00 * a22 - a02 * a02)
    b02 = inv_det * (a01 * a12 - a02 * a11)
    b12 = inv_det * (a02 * a01 - a00 * a12)
    b22 = inv_det * (a00 * a11 - a01 * a01)
    return torch.stack([b00, b01, b02, b01, b11, b12, b02, b12, b22])


def hll_inverse_plain(HllT, lam):
    """:func:`hll_inverse_rows` in torch: the diagonal damped in the
    working dtype, the inverse in fp64, rounded back, and bl."""
    hll_d = HllT[:9].clone()
    hll_d[0::4] += lam
    iv9 = _sym3x3_inv_rows(hll_d.double()).to(hll_d.dtype)
    return torch.cat([iv9, HllT[9:12]])


def hll_inverse_rows(HllT, lam):
    """[Hll^-1 (9 rows); bl (3 rows)] [12, L] of HllT [12, L] damped by
    ``lam``.  Near-singular landmarks make an fp32 determinant cancel, so
    the inverse is taken in fp64 on every route.  On the card one
    ``hll_inverse`` launch (``lam`` read there); on the CPU, and under
    ``cudalib.use_plain()``, :func:`hll_inverse_plain`."""
    with trace.span("k.hll_inverse"):
        if cudalib.use_kernel(HllT):
            return factors.hll_inverse(HllT, lam)
        return hll_inverse_plain(HllT, lam)


def slot_factors_plain(HplT, g12):
    """:func:`slot_factors_rows` in torch: two einsums."""
    H = g12.shape[1]
    W = torch.einsum("ike,kme->ime", HplT.view(6, 3, H), g12[:9].view(3, 3, H))
    wbl = torch.einsum("ime,me->ie", W, g12[9:12]).contiguous()
    return W.reshape(18, H), wbl


def slot_factors_rows(HplT, g12):
    """(W [18, H], W bl [6, H]) of the slots: W = Hpl Hll^-1 (row i*3+m)
    from HplT [18, H] and the gathered [Hll^-1; bl] g12 [12, H].  On the
    card one ``slot_factors`` launch; on the CPU, and under
    ``cudalib.use_plain()``, :func:`slot_factors_plain`."""
    with trace.span("k.slot_factors"):
        if cudalib.use_kernel(HplT, g12):
            return factors.slot_factors(HplT, g12)
        return slot_factors_plain(HplT, g12)


def slot_factors_scale(HplT, g12):
    """Each entry's sum of |products| in :func:`slot_factors_rows`: (|Hpl|
    |Hll^-1| [18, H], (|Hpl| |Hll^-1|) |bl| [6, H]), the scale that two
    summation orders' results are compared on."""
    return slot_factors_plain(HplT.abs(), g12.abs())


def prepare_factors(HppT, HllT, HplT, lam, num_p, rc: RowConsts, group=None):
    """Damped inverse Hll, W = Hpl Hll^-1 and bsc = bp - W bl, transposed.

    Returns (iv9 [9, L], W [18, hpl_pad], bscT [6, P], g12 [12, hpl_pad]).
    ``group``: the landmark shards' process group, over which the W bl pose
    sum is all-reduced (HppT must already be the global one; HllT and HplT
    are the shard's)."""
    with trace.span("rows.prepare_factors"):
        src12 = hll_inverse_rows(HllT, lam)
        g12 = segmm.gather(src12, rc.hpl_col)
        W, wbl = slot_factors_rows(HplT, g12)
        bsc_sub = segmm.segsum(wbl, rc.hpl_row, num_p, rc.csr_hpl_row)
        return src12[:9], W, HppT[36:42] - comm.all_reduce_sum(bsc_sub, group), g12


def schur_compact(W, HplT, plan: RowPlan, rc: RowConsts):
    """The band-major compact table gT [36, M*Wg] = + sum of W Hpl^T over
    every Hsc block: schur_fused's per-chunk windows combined by gkey_up2."""
    sc = plan.schur
    win = segmm.schur_fused(W.contiguous(), HplT, sc, rc.sc_sb, rc.sc_li, rc.sc_lj,
                            rc.sc_lk, csr=rc.csr_sc)
    M = plan.pad_blocks // 64
    return segmm.segsum(win, rc.gkey_up2, M * plan.wg, rc.csr_up2)


def damped_diagonal_T(HppT, lam, num_p: int, PB: int) -> torch.Tensor:
    """dbT [36, PB]: the damped Hpp blocks, identity on the padding poses."""
    eye = torch.eye(6, dtype=HppT.dtype, device=HppT.device)
    hpp_d = HppT[:36].T.reshape(num_p, 6, 6) + lam * eye
    return torch.cat([hpp_d, eye.expand(PB - num_p, 6, 6)]).reshape(PB, 36).T.contiguous()


def band_from_compact(gT, HppT, lam, num_p, plan: RowPlan, rc: RowConsts, with_ob=False):
    """Damped diagonal + the compact table placed into block-tridiagonal
    storage: (D [M, 384, 384], U [M, 384, 384]), U[k] = A[k, k+1].
    ``with_ob`` adds the out-of-band (loop-closure) blocks A[r, c] [n_ob, 6,
    6] that the band storage drops, gathered from the table (the Schur block
    is the negated table entry)."""
    PB = plan.pad_blocks
    band = segmm.compact_to_band(gT, rc.iru, rc.icu, damped_diagonal_T(HppT, lam, num_p, PB),
                                 rc.band_occ, PB, plan.wg, table=rc.band_table)
    arr = band.view(PB // 64, 384, 2, 384)
    if with_ob:
        Vob = -(gT.index_select(1, rc.ob_rkey).T.reshape(-1, 6, 6))
        return arr[:, :, 0, :], arr[:, :, 1, :], Vob
    return arr[:, :, 0, :], arr[:, :, 1, :]


def schur_band(HppT, W, HplT, lam, num_p, plan: RowPlan, rc: RowConsts, with_ob=False):
    """The damped Schur complement in block-tridiagonal storage (D, U),
    never formed densely (v2 formation only); ``with_ob`` as
    :func:`band_from_compact`."""
    gT = schur_compact(W, HplT, plan, rc)
    return band_from_compact(gT, HppT, lam, num_p, plan, rc, with_ob)


def dense_from_compact(gT, HppT, lam, num_p, plan: RowPlan, rc: RowConsts):
    """Damped diagonal + the compact table placed into the dense damped
    Schur matrix [6PB, 6PB]."""
    PB = plan.pad_blocks
    return segmm.compact_to_dense(gT, rc.iru, rc.icu, damped_diagonal_T(HppT, lam, num_p, PB),
                                  rc.occ2, PB, plan.wg, table=rc.dense_table)


def schur_dense(HppT, W, HplT, lam, num_p, plan: RowPlan, rc: RowConsts):
    """The damped Schur complement as a dense [6PB, 6PB] matrix, with no
    scatter: from the compact table (v2), or from the dense block table
    (v1, :func:`schur_dense_v1`)."""
    if not plan.v2:
        return schur_dense_v1(HppT, W, HplT, lam, num_p, plan, rc)
    gT = schur_compact(W, HplT, plan, rc)
    return dense_from_compact(gT, HppT, lam, num_p, plan, rc)


def dense_block_table(W, HplT, plan: RowPlan, rc: RowConsts):
    """The v1 formation's damped-free block table m4 [36, PB, PB] = -(upper
    + mirrored blocks): schur_fused's windows combined twice over the dense
    block keys, gkey_up (r*PB + c) and gkey_lo (c*PB + r, transposed)."""
    PB = plan.pad_blocks
    win = segmm.schur_fused(W.contiguous(), HplT, plan.schur, rc.sc_sb, rc.sc_li, rc.sc_lj,
                            rc.sc_lk, csr=rc.csr_sc)
    m4 = segmm.segsum(win, rc.gkey_up, PB * PB, rc.csr_up)
    lo = segmm.segsum(win, rc.gkey_lo, PB * PB, rc.csr_lo)
    del win
    # in place, row by row: each [36, PB*PB] table is 285 MB at PB = 1408
    for k, pk in enumerate(_PERM36.tolist()):
        m4[k] += lo[pk]
    del lo
    return m4.neg_().view(36, PB, PB)


def schur_dense_v1(HppT, W, HplT, lam, num_p, plan: RowPlan, rc: RowConsts):
    """The v1 dense formation (cuba_tpu schur_dense_mxu's ``not plans.v2``
    branch): the block table of :func:`dense_block_table`, the damped
    diagonal added on its block diagonal, interleaved by
    ``band_transpose``."""
    PB = plan.pad_blocks
    m4 = dense_block_table(W, HplT, plan, rc)
    m4.diagonal(dim1=1, dim2=2).add_(damped_diagonal_T(HppT, lam, num_p, PB))
    return segmm.band_transpose(m4, rc.occ, PB)


def back_substitute(iv9, HllT, HplT, g12, xp, num_l, rc: RowConsts):
    """xl = Hll^-1 (bl - Hpl^T xp) in transposed layout.  Returns [L, 3]."""
    with trace.span("rows.back_substitute"):
        xpg = segmm.gather(xp.T.contiguous(), rc.hpl_row)
        H = xpg.shape[1]
        contrib = torch.einsum("ike,ie->ke", HplT.view(6, 3, H), xpg).contiguous()
        red = segmm.segsum(contrib, rc.hpl_col, num_l, rc.csr_hpl_col)
        clT = HllT[9:12] - red
        return torch.einsum("mje,je->me", iv9.view(3, 3, -1), clT).T


def _hpp_matvec_rows(HppT, lam, xT):
    """(Hpp + lam I) x over transposed rows: xT [6, P] -> [6, P]."""
    return torch.einsum("ije,je->ie", HppT[:36].view(6, 6, -1), xT) + lam * xT


def schur_matvec_rows(HppT, HplT, W, lam, xT, num_p, num_l, rc: RowConsts, group=None):
    """Matrix-free Schur matvec Hsc x = (Hpp + lam I) x - W (Hpl^T x): a slot
    gather of x, a per-landmark segment sum, a gather back to the slots and
    a pose-side accumulate, all-reduced over ``group``'s landmark shards (x
    is the same on every rank)."""
    with trace.span("rows.schur_matvec"):
        xg = segmm.gather(xT.contiguous(), rc.hpl_row)
        H = xg.shape[1]
        a3 = torch.einsum("ike,ie->ke", HplT.view(6, 3, H), xg).contiguous()
        aL = segmm.segsum(a3, rc.hpl_col, num_l, rc.csr_hpl_col)
        ag = segmm.gather(aL, rc.hpl_col)
        y6 = torch.einsum("ike,ke->ie", W.view(6, 3, H), ag).contiguous()
        ysub = segmm.segsum(y6, rc.hpl_row, num_p, rc.csr_hpl_row)
        return _hpp_matvec_rows(HppT, lam, xT) - comm.all_reduce_sum(ysub, group)


def schur_block_diag_inv(HppT, HplT, W, lam, num_p, rc: RowConsts, group=None):
    """Inverted exact 6x6 block diagonal of the damped Schur complement,
    [6, 6, P]: the block-Jacobi preconditioner (its slot sum all-reduced
    over ``group``'s landmark shards)."""
    with trace.span("rows.block_diag_inv"):
        H = HplT.shape[1]
        d36 = torch.einsum("ike,jke->ije", W.view(6, 3, H), HplT.view(6, 3, H)).reshape(36, H)
        corr = segmm.segsum(d36.contiguous(), rc.hpl_row, num_p, rc.csr_hpl_row)
        M = (HppT[:36] - comm.all_reduce_sum(corr, group)).T.reshape(num_p, 6, 6)
        M = M + lam * torch.eye(6, dtype=M.dtype, device=M.device)
        # inv_ex: a singular block gives non-finite values (and a rejected step)
        # without the host synchronisation of torch.linalg.inv's error check
        Minv = torch.linalg.inv_ex(M).inverse
        return Minv.reshape(num_p, 36).T.reshape(6, 6, num_p)


def pcg_solve_rows(HppT, HplT, W, lam, bT, num_p, num_l, rc: RowConsts, max_iterations: int,
                   tol: float, group=None):
    """Block-Jacobi preconditioned CG on the matrix-free Schur operator.
    Returns (xT [6, P], ok, k): ok is False on non-convergence (and x is
    then 0), k is the number of CG steps.  The recurrence residual is kept
    as written (b - Ax is never recomputed).  The stop test reads the host
    once per step.  ``group``: the landmark shards' process group of the
    matvec's and the preconditioner's pose sums; every other quantity is
    in pose space, the same on every rank."""
    Minv = schur_block_diag_inv(HppT, HplT, W, lam, num_p, rc, group)

    def apply_M(rT):
        return torch.einsum("ije,je->ie", Minv, rT)

    def dot(a, c):
        return (a * c).sum()

    tol2 = (tol * tol) * dot(bT, bT)
    x = torch.zeros_like(bT)
    r = bT
    z = apply_M(bT)
    p = z
    rz = dot(bT, z)
    one = torch.ones((), dtype=bT.dtype, device=bT.device)
    rr = dot(r, r)
    k = 0
    while k < max_iterations:
        with trace.span("read.cg_stop"):
            if not bool(rr > tol2):
                break
        Ap = schur_matvec_rows(HppT, HplT, W, lam, p, num_p, num_l, rc, group)
        pAp = dot(p, Ap)
        alpha = rz / torch.where(pAp == 0, one, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_M(r)
        rz_new = dot(r, z)
        beta = rz_new / torch.where(rz == 0, one, rz)
        p = z + beta * p
        rz = rz_new
        rr = dot(r, r)
        k += 1
    ok = (rr <= tol2) & torch.isfinite(x).all()
    return torch.where(ok, x, torch.zeros_like(x)), ok, k


def max_diagonal_T(HppT, HllT):
    """Max over the block-diagonal entries of the system, floored at 0."""
    mp = HppT[0:36:7].max()
    ml = HllT[0:9:4].max()
    return torch.clamp(torch.maximum(mp, ml), min=0.0)
