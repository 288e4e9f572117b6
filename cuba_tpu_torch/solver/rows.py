"""The rows front end and the matrix-free PCG reduced solve (the PCG subset
of ``cuba_tpu/solver/mxu.py``), over transposed ``[D, N]`` tensors.

Every index-driven step goes through the wrappers of ``ops/segmm.py``
(hand-written CUDA kernels on the card); the per-slot 6x6/3x3 block algebra
is reshapes and einsums.  Function by function:

=========================  ==================================
this module                ``cuba_tpu/solver/mxu.py``
=========================  ==================================
``plan_rows``              ``plan_mxu(need_dense=False, wire_pack=False)``
                           (688-1116) and ``pose_ranks`` (325)
``edge_rows``              ``edge_rows_mxu`` (1428)
``_pose_accum``            ``_pose_accum`` (1478)
``build_system_rows``      ``build_system_rows`` (1488)
``_sym3x3_inv_rows``       ``_sym3x3_inv_rows`` (1548)
``prepare_factors``        ``prepare_factors_mxu`` (1575)
``back_substitute``        ``back_substitute_mxu`` (1757)
``_hpp_matvec_rows``       ``_hpp_matvec_rows`` (1778)
``schur_matvec_rows``      ``schur_matvec_rows`` (1786)
``schur_block_diag_inv``   ``schur_block_diag_inv_rows`` (1822)
``pcg_solve_rows``         ``pcg_solve_rows`` (1839)
``max_diagonal_T``         ``max_diagonal_T`` (1904)
=========================  ==================================

Table layouts: HppT [42, P] (Hpp row-major 36, then bp 6), HllT [12, L]
(Hll 9, then bl 3), HplT [18, hpl_pad] (Hpl row-major i*3+k per slot).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cuba_tpu_torch.ops import segmm
from cuba_tpu_torch.ops.segmm import AccumWindowPlan, SegmentCSR, TilePlan
from cuba_tpu_torch.solver import edgerows
from cuba_tpu_torch.solver.structure import BAStructure


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad_ids(ids, n, valid_mask=None):
    """-1-padded int32 table of ``ids``."""
    out = np.full(n, -1, np.int32)
    v = np.asarray(ids, np.int32)
    out[: v.size] = v if valid_mask is None else np.where(valid_mask, v, np.int32(-1))
    return out


def pose_ranks(s: BAStructure) -> np.ndarray:
    """Rank every pose (active and fixed) by its first observation in the
    locality-ordered edge stream: the rank-ordered gather's column order."""
    total_p = int(s.qs.shape[0])
    allp = np.concatenate([np.asarray(s.mono.pose_idx, np.int64),
                           np.asarray(s.stereo.pose_idx, np.int64)])
    first = np.full(total_p, np.int64(1) << 60)
    # reversed assignment: the last write (= first position) wins
    first[allp[::-1]] = np.arange(allp.size - 1, -1, -1, dtype=np.int64)
    rorder = np.argsort(first, kind="stable")
    prank = np.empty(total_p, np.int64)
    prank[rorder] = np.arange(total_p)
    return prank


@dataclasses.dataclass
class RowPlan:
    """Host plan of one structure: paddings and the TPU window plans, kept
    so that paddings and the choice of wrapper match ``cuba_tpu``'s."""

    e_pad_m: int
    e_pad_s: int
    hpl_pad: int
    p_src_pad: int
    p_res_pad: int
    hll_m: TilePlan
    hll_s: TilePlan
    hpl_m: TilePlan
    hpl_s: TilePlan
    ivs: TilePlan  # gather [invHll; bl] rows by hpl_col
    xpg: TilePlan  # gather pose rows by hpl_row
    cl: TilePlan  # segment-sum slot rows by hpl_col
    xwg_m: TilePlan
    xwg_s: TilePlan
    paw_m: AccumWindowPlan
    paw_s: AccumWindowPlan
    paw_b: AccumWindowPlan
    rg_m: Optional[AccumWindowPlan]  # None: the rank-ordered pose gather is off
    rg_s: Optional[AccumWindowPlan]


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
    pose_gidr_m: Optional[torch.Tensor]  # rank-ordered pose ids (rg plans)
    pose_gidr_s: Optional[torch.Tensor]
    res_perm: Optional[torch.Tensor]  # [p_res_pad] source column order (rg plans)
    # the fixed summation order of every segment-sum call site
    csr_pose_m: SegmentCSR
    csr_pose_s: SegmentCSR
    csr_lm_m: SegmentCSR
    csr_lm_s: SegmentCSR
    csr_e2h_m: SegmentCSR
    csr_e2h_s: SegmentCSR
    csr_hpl_row: SegmentCSR
    csr_hpl_col: SegmentCSR


def plan_row_tables(s: BAStructure):
    """The host half of :func:`plan_rows`: (RowPlan, {name: np.ndarray}).
    Paddings, plans and tables equal ``cuba_tpu``'s ``plan_mxu(s,
    need_dense=False, wire_pack=False)``."""
    num_p, num_l, n_hpl = s.num_p, s.num_l, s.n_hpl
    if num_p == 0 or num_l == 0 or n_hpl == 0:
        raise NotImplementedError(
            "pose-only and landmark-only problems need the fallback path "
            "(ROADMAP queue 1, 'Fallback path'), which is not ported yet"
        )
    Em, Es = s.mono.count, s.stereo.count
    e_pad_m = max(_round_up(Em, 1024), 1024)
    e_pad_s = max(_round_up(Es, 1024), 1024)
    hpl_pad = max(_round_up(n_hpl, 1024), 1024)
    p_src_pad = max(_round_up(num_p + 1, 1024), 1024)
    # paddings and plan windows depend on each other: iterate to a fixpoint
    for _ in range(4):
        lm_m = _pad_ids(s.mono.lm_idx, e_pad_m, s.mono.lm_idx < num_l)
        lm_s = _pad_ids(s.stereo.lm_idx, e_pad_s, s.stereo.lm_idx < num_l)
        e2h_m = _pad_ids(s.edge2hpl[:Em], e_pad_m, s.edge2hpl[:Em] < n_hpl)
        e2h_s = _pad_ids(s.edge2hpl[Em:], e_pad_s, s.edge2hpl[Em:] < n_hpl)
        hcol = _pad_ids(s.hpl_col, hpl_pad)
        hrow = _pad_ids(s.hpl_row, hpl_pad)
        hll_m = segmm.plan_tiles(lm_m, num_l)
        hll_s = segmm.plan_tiles(lm_s, num_l)
        hpl_m = segmm.plan_tiles(e2h_m, hpl_pad)
        hpl_s = segmm.plan_tiles(e2h_s, hpl_pad)
        ivs = segmm.plan_gather_tiles(hcol, num_l)
        xpg = segmm.plan_gather_tiles(hrow, num_p, block=p_src_pad, max_blocks=1)
        cl = segmm.plan_tiles(hcol, num_l)
        need_em = max(e_pad_m, _round_up(max(hll_m.n_pad, hpl_m.n_pad), 1024))
        need_es = max(e_pad_s, _round_up(max(hll_s.n_pad, hpl_s.n_pad), 1024))
        need_hpl = max(hpl_pad, _round_up(max(
            ivs.num_tiles * ivs.tile, xpg.num_tiles * xpg.tile, cl.n_pad), 1024))
        if (need_em, need_es, need_hpl) == (e_pad_m, e_pad_s, hpl_pad):
            break
        e_pad_m, e_pad_s, hpl_pad = need_em, need_es, need_hpl

    total_p = int(s.qs.shape[0])
    total_l = int(s.Xws.shape[0])
    p_res_pad = _round_up(max(total_p, 1), 128)
    pose_gid_m = _pad_ids(s.mono.pose_idx, e_pad_m)
    pose_gid_s = _pad_ids(s.stereo.pose_idx, e_pad_s)
    lm_gid_m = _pad_ids(s.mono.lm_idx, e_pad_m)
    lm_gid_s = _pad_ids(s.stereo.lm_idx, e_pad_s)
    xwg_m = segmm.plan_gather_tiles(lm_gid_m, total_l)
    xwg_s = segmm.plan_gather_tiles(lm_gid_s, total_l)

    prank = pose_ranks(s)
    rorder = np.empty(total_p, np.int64)
    rorder[prank] = np.arange(total_p)
    pose_gidr_m = _pad_ids(prank[np.asarray(s.mono.pose_idx, np.int64)], e_pad_m)
    pose_gidr_s = _pad_ids(prank[np.asarray(s.stereo.pose_idx, np.int64)], e_pad_s)
    rg_m = segmm.plan_accum_windows(pose_gidr_m, total_p, max_win=1024)
    rg_s = segmm.plan_accum_windows(pose_gidr_s, total_p, max_win=1024)
    tables = {}
    if rg_m.ok and rg_s.ok:
        p_res_pad = max(p_res_pad, rg_m.out_pad, rg_s.out_pad)
        res_perm = np.full(p_res_pad, total_p, np.int32)
        res_perm[:total_p] = rorder
        tables.update(pose_gidr_m=pose_gidr_m, pose_gidr_s=pose_gidr_s, res_perm=res_perm)
    else:
        rg_m = rg_s = None

    pacc_m = _pad_ids(s.mono.pose_idx, e_pad_m, s.mono.pose_idx < num_p)
    pacc_s = _pad_ids(s.stereo.pose_idx, e_pad_s, s.stereo.pose_idx < num_p)
    plan = RowPlan(
        e_pad_m, e_pad_s, hpl_pad, p_src_pad, p_res_pad,
        hll_m, hll_s, hpl_m, hpl_s, ivs, xpg, cl, xwg_m, xwg_s,
        segmm.plan_accum_windows(pacc_m, num_p),
        segmm.plan_accum_windows(pacc_s, num_p),
        segmm.plan_accum_windows(_pad_ids(s.hpl_row, hpl_pad), num_p),
        rg_m, rg_s,
    )
    tables.update(
        pose_gid_m=pose_gid_m, pose_gid_s=pose_gid_s, lm_gid_m=lm_gid_m, lm_gid_s=lm_gid_s,
        pose_acc_m=pacc_m, pose_acc_s=pacc_s, lm_acc_m=lm_m, lm_acc_s=lm_s,
        e2h_m=e2h_m, e2h_s=e2h_s, hpl_row=hrow, hpl_col=hcol,
    )
    return plan, tables


def plan_rows(s: BAStructure, device, dtype):
    """Plan a structure and upload its tables: (RowPlan, RowConsts)."""
    plan, t = plan_row_tables(s)
    Em, Es = s.mono.count, s.stereo.count
    measT_m = np.zeros((2, plan.e_pad_m))
    measT_m[:, :Em] = s.mono.measurements.T
    measT_s = np.zeros((3, plan.e_pad_s))
    measT_s[:, :Es] = s.stereo.measurements.T
    omegaT_m = np.zeros(plan.e_pad_m)
    omegaT_m[:Em] = s.mono.omegas
    omegaT_s = np.zeros(plan.e_pad_s)
    omegaT_s[:Es] = s.stereo.omegas

    def ints(name):
        return torch.from_numpy(t[name]).to(device) if name in t else None

    def floats(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def csr(name, num_out):
        return segmm.segment_csr(t[name], num_out, device)

    consts = RowConsts(
        measT_m=floats(measT_m), measT_s=floats(measT_s),
        omegaT_m=floats(omegaT_m), omegaT_s=floats(omegaT_s),
        **{name: ints(name) for name in (
            "pose_gid_m", "pose_gid_s", "lm_gid_m", "lm_gid_s",
            "pose_acc_m", "pose_acc_s", "lm_acc_m", "lm_acc_s",
            "e2h_m", "e2h_s", "hpl_row", "hpl_col",
            "pose_gidr_m", "pose_gidr_s", "res_perm")},
        csr_pose_m=csr("pose_acc_m", s.num_p), csr_pose_s=csr("pose_acc_s", s.num_p),
        csr_lm_m=csr("lm_acc_m", s.num_l), csr_lm_s=csr("lm_acc_s", s.num_l),
        csr_e2h_m=csr("e2h_m", plan.hpl_pad), csr_e2h_s=csr("e2h_s", plan.hpl_pad),
        csr_hpl_row=csr("hpl_row", s.num_p), csr_hpl_col=csr("hpl_col", s.num_l),
    )
    return plan, consts


# ---------------------------------------------------------------------------
# device phases
# ---------------------------------------------------------------------------


def edge_rows(qs, ts, Xws, cams, kernels, chi_dtype, counts, plan: RowPlan, rc: RowConsts):
    """Residual front end.  Returns (pack_m, pack_s, chi); pack = (g12
    [12, E], err [mdim, E], Xc [3, E], inv_z [E]), or None for an absent
    edge type."""
    total_p = qs.shape[0]
    psrc = torch.zeros((12, plan.p_res_pad), dtype=qs.dtype, device=qs.device)
    psrc[:, :total_p] = torch.cat([qs, ts, cams], dim=1).T
    if plan.rg_m is not None:
        # first-observation column order: each edge chunk reads a narrow band
        psrc = psrc.index_select(1, rc.res_perm)
    XwT = Xws.T.contiguous()
    chi = torch.zeros((), dtype=chi_dtype, device=qs.device)
    packs = []
    for count, pgid, lgid, xwg, measT, omegaT, mdim, kern, rgp, rgid in (
        (counts[0], rc.pose_gid_m, rc.lm_gid_m, plan.xwg_m, rc.measT_m, rc.omegaT_m, 2,
         kernels[0], plan.rg_m, rc.pose_gidr_m),
        (counts[1], rc.pose_gid_s, rc.lm_gid_s, plan.xwg_s, rc.measT_s, rc.omegaT_s, 3,
         kernels[1], plan.rg_s, rc.pose_gidr_s),
    ):
        if count == 0:
            packs.append(None)
            continue
        if rgp is not None:
            g12 = segmm.windowed_gather(psrc, rgid, rgp, rgp.wb)
        else:
            g12 = segmm.resident_gather(psrc, pgid)
        xw = segmm.tiled_gather(XwT, lgid, xwg, xwg.base_block)
        err, Xc, _R, inv_z = edgerows.residual_rows(g12, xw, measT, pgid >= 0, mdim)
        chi = chi + edgerows.chi_rows(err, omegaT, kern, chi_dtype)
        packs.append((g12, err, Xc, inv_z))
    return packs[0], packs[1], chi


def _pose_accum(v, pose_ids, num_p, paw: AccumWindowPlan, csr: SegmentCSR):
    """Pose-side accumulate: the windowed wrapper where cuba_tpu's window
    plan holds, the full-width one otherwise."""
    if paw.ok:
        return segmm.accum_segsum_windowed(v, pose_ids, num_p, paw, paw.wb, csr=csr)
    return segmm.accum_segsum(v, pose_ids, num_p, csr=csr)


def build_system_rows(pack_m, pack_s, kernels, num_p, num_l, plan: RowPlan, rc: RowConsts):
    """Quadratic-form assembly from the residual packs: (HppT, HllT, HplT)."""
    outs = []
    for pack, omegaT, mdim, kern, pose_ids, lm_ids, e2h, hll_p, hpl_p, paw, c_p, c_l, c_h in (
        (pack_m, rc.omegaT_m, 2, kernels[0], rc.pose_acc_m, rc.lm_acc_m, rc.e2h_m,
         plan.hll_m, plan.hpl_m, plan.paw_m, rc.csr_pose_m, rc.csr_lm_m, rc.csr_e2h_m),
        (pack_s, rc.omegaT_s, 3, kernels[1], rc.pose_acc_s, rc.lm_acc_s, rc.e2h_s,
         plan.hll_s, plan.hpl_s, plan.paw_s, rc.csr_pose_s, rc.csr_lm_s, rc.csr_e2h_s),
    ):
        if pack is None:
            continue
        g12, err, Xc, inv_z = pack
        R = edgerows.rotmat_rows(g12[0:4])
        v42, v12, v18 = edgerows.term_rows(err, Xc, R, inv_z, g12[7:12], omegaT, kern, mdim)
        HppT = _pose_accum(v42, pose_ids, num_p, paw, c_p)
        HllT = segmm.tiled_segsum(v12, lm_ids, num_l, hll_p, hll_p.base_block, csr=c_l)
        HplT = segmm.tiled_segsum(v18, e2h, plan.hpl_pad, hpl_p, hpl_p.base_block, csr=c_h)
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


def prepare_factors(HppT, HllT, HplT, lam, num_p, num_l, plan: RowPlan, rc: RowConsts):
    """Damped inverse Hll, W = Hpl Hll^-1 and bsc = bp - W bl, transposed.

    Returns (iv9 [9, L], W [18, hpl_pad], bscT [6, P], g12 [12, hpl_pad])."""
    hll_d = HllT[:9].clone()
    hll_d[0::4] += lam
    # near-singular landmarks make an fp32 determinant cancel: invert in fp64
    iv9 = _sym3x3_inv_rows(hll_d.double()).to(hll_d.dtype)
    src12 = torch.cat([iv9, HllT[9:12]])
    g12 = segmm.tiled_gather(src12, rc.hpl_col, plan.ivs, plan.ivs.base_block)
    H = g12.shape[1]
    W = torch.einsum("ike,kme->ime", HplT.view(6, 3, H), g12[:9].view(3, 3, H))
    wbl = torch.einsum("ime,me->ie", W, g12[9:12]).contiguous()
    bsc_sub = _pose_accum(wbl, rc.hpl_row, num_p, plan.paw_b, rc.csr_hpl_row)
    return iv9, W.reshape(18, H), HppT[36:42] - bsc_sub, g12


def back_substitute(iv9, HllT, HplT, g12, xp, num_l, plan: RowPlan, rc: RowConsts):
    """xl = Hll^-1 (bl - Hpl^T xp) in transposed layout.  Returns [L, 3]."""
    xpg = segmm.tiled_gather(xp.T.contiguous(), rc.hpl_row, plan.xpg, plan.xpg.base_block)
    H = xpg.shape[1]
    contrib = torch.einsum("ike,ie->ke", HplT.view(6, 3, H), xpg).contiguous()
    red = segmm.tiled_segsum(contrib, rc.hpl_col, num_l, plan.cl, plan.cl.base_block,
                             csr=rc.csr_hpl_col)
    clT = HllT[9:12] - red
    return torch.einsum("mje,je->me", iv9.view(3, 3, -1), clT).T


def _hpp_matvec_rows(HppT, lam, xT):
    """(Hpp + lam I) x over transposed rows: xT [6, P] -> [6, P]."""
    return torch.einsum("ije,je->ie", HppT[:36].view(6, 6, -1), xT) + lam * xT


def schur_matvec_rows(HppT, HplT, W, lam, xT, num_p, num_l, plan: RowPlan, rc: RowConsts):
    """Matrix-free Schur matvec Hsc x = (Hpp + lam I) x - W (Hpl^T x): a slot
    gather of x, a per-landmark segment sum, a gather back to the slots and
    a pose-side accumulate."""
    xg = segmm.tiled_gather(xT.contiguous(), rc.hpl_row, plan.xpg, plan.xpg.base_block)
    H = xg.shape[1]
    a3 = torch.einsum("ike,ie->ke", HplT.view(6, 3, H), xg).contiguous()
    aL = segmm.tiled_segsum(a3, rc.hpl_col, num_l, plan.cl, plan.cl.base_block,
                            csr=rc.csr_hpl_col)
    ag = segmm.tiled_gather(aL, rc.hpl_col, plan.ivs, plan.ivs.base_block)
    y6 = torch.einsum("ike,ke->ie", W.view(6, 3, H), ag).contiguous()
    ysub = _pose_accum(y6, rc.hpl_row, num_p, plan.paw_b, rc.csr_hpl_row)
    return _hpp_matvec_rows(HppT, lam, xT) - ysub


def schur_block_diag_inv(HppT, HplT, W, lam, num_p, plan: RowPlan, rc: RowConsts):
    """Inverted exact 6x6 block diagonal of the damped Schur complement,
    [6, 6, P]: the block-Jacobi preconditioner."""
    H = HplT.shape[1]
    d36 = torch.einsum("ike,jke->ije", W.view(6, 3, H), HplT.view(6, 3, H)).reshape(36, H)
    corr = _pose_accum(d36.contiguous(), rc.hpl_row, num_p, plan.paw_b, rc.csr_hpl_row)
    M = (HppT[:36] - corr).T.reshape(num_p, 6, 6)
    M = M + lam * torch.eye(6, dtype=M.dtype, device=M.device)
    # inv_ex: a singular block gives non-finite values (and a rejected step)
    # without the host synchronisation of torch.linalg.inv's error check
    Minv = torch.linalg.inv_ex(M).inverse
    return Minv.reshape(num_p, 36).T.reshape(6, 6, num_p)


def pcg_solve_rows(HppT, HplT, W, lam, bT, num_p, num_l, plan: RowPlan, rc: RowConsts,
                   max_iterations: int, tol: float):
    """Block-Jacobi preconditioned CG on the matrix-free Schur operator.
    Returns (xT [6, P], ok, k): ok is False on non-convergence (and x is
    then 0), k is the number of CG steps.  The recurrence residual is kept
    as written (b - Ax is never recomputed).  The stop test reads the host
    once per step."""
    Minv = schur_block_diag_inv(HppT, HplT, W, lam, num_p, plan, rc)

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
    while k < max_iterations and bool(rr > tol2):
        Ap = schur_matvec_rows(HppT, HplT, W, lam, p, num_p, num_l, plan, rc)
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
