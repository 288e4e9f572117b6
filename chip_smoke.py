#!/usr/bin/env python3
"""Drive cuba_tpu_torch's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--num-poses 4096]

Phases (any failure exits non-zero, before the result line):

1. Device and build: the card's name and power limit, the torch and CUDA
   versions, the nvcc builds of ``cuba_tpu_torch/csrc/segmm.cu`` and
   ``csrc/trisolve.cu`` (one nvcc each, in parallel, timed) and which
   symbolic pass (C++ or NumPy) the host runs.
2. Kernels against their plain torch versions, on the slice's own plan and
   tensors (the problem below after ``initialize()``): gathers must be equal
   bit for bit, segment sums within 1e-5 of each output's sum of |vals|.
   Median CUDA-event times over 25 repeats of each.
3. The main path through the public API: the matrix-free PCG problem of
   ``tools/bench_pcg_crossover.py`` at P = 4096 poses, 61,440 landmarks
   (~5 observations each, 25% stereo, seed 0, gentle initial noise), Huber
   kernels, ``BAConfig(dtype=float32, solver="pcg", device="cuda")``:
   ``initialize()`` and ``optimize(10)`` once to warm up and once timed from
   a fresh graph.  chi² must be finite and fall; every kernel wrapper the
   plan routes through must have launched.
4. The same ``optimize(10)`` with the plain versions on the card: the chi²
   trajectories must agree to rtol 5e-3 per iteration.
5. The band path through the public API: ``bench.py``'s kitti00-scale loop
   graph (1322 poses, 133,383 landmarks, ``mean_obs`` 5.5, 25% stereo, seed
   0, ``loop_closure=True``), Huber kernels, ``BAConfig(dtype=float32,
   device="cuda")`` with ``solver="auto"``: ``initialize()`` +
   ``optimize(10)`` once to warm up and once timed from a fresh graph.  The
   engine must resolve to ``band_cr`` with 22 CR blocks, chi² must be
   finite and fall, the final chi² must lie within ``bench.CHI2_REL_BAND``
   of the recorded fp64 value ``bench.CHI2_FP64_FINAL``, and every kernel
   of the path must have launched.
6. Every kernel of the band path against its plain version on that run's
   plan and first-attempt tensors: kernels 1-6 at phase 2's call sites,
   ``tiled_segsum`` also at the combine of ``rows.schur_compact``, and
   kernels 7-8 (``schur_fused``, ``compact_to_band``).  Gathers and
   ``compact_to_band`` equal bit for bit, sums within 1e-5 of each
   output's sum of |terms|; median CUDA-event times of 25 launches; and
   the cyclic-reduction factor + solve of that band with each
   diagonal-block inverse (``_inv_spd_rs``, ``_inv_spd_chol``).
7. Phase 5's run with the plain versions on the card: the chi²
   trajectories must agree to rtol 5e-3 per iteration.
8. The dense path through the public API: ``bench.py --quick``'s kitti07
   graph (248 poses, 26,127 landmarks, ``mean_obs`` 4.65, 25% stereo, seed
   0, ``loop_closure=False``), Huber kernels, ``BAConfig(dtype=float32,
   device="cuda")`` with ``solver="auto"``: ``initialize()`` +
   ``optimize(10)`` once to warm up and once counted and timed from a fresh
   graph.  The engine must resolve to ``dense_cholesky``, chi² must be
   finite and fall, the final chi² must lie within ``bench.CHI2_REL_BAND``
   of ``bench.CHI2_FP64_FINAL[("kitti07_scale", 10)]``, and every kernel of
   the path must have launched.
9. Every kernel of the dense path against its plain version on the warm-up
   engine's first-attempt tensors: kernels 1-7 as in phase 6, then
   ``compact_to_dense`` and ``extract_diag_blocks`` bit for bit, ``matvec``
   within 1e-5 of each row's sum of |A_ij x_j|, ``solve_lower`` /
   ``solve_upper`` within SOLVE_RTOL of max |result|; median CUDA-event
   times of 25 launches; the whole ``cholesky_solve`` against the same call
   under ``use_plain()`` and the sweeps against ``torch.linalg.
   solve_triangular``; one damped attempt timed phase by phase.  Then the
   same kernel checks on the kitti00 loop graph built with
   ``solver="dense_cholesky"`` (n = 8448), and its ``optimize(10)``, whose
   chi² must be finite and fall (its final chi² is logged, not gated).
10. Phase 8's run with the plain versions on the card: the chi²
   trajectories must agree to rtol 5e-3 per iteration.

The line before the last is a JSON object with one entry per kernel and
path (``"path"``: ``pcg`` from phases 2-3, ``band`` from phases 5-6,
``dense`` from phases 8-9 at kitti07, ``dense-kitti00`` from phase 9's
kitti00 engine; ``"site"`` names a second call site of one kernel).
``launches`` is the kernel's count in that path's counted run, over all its
call sites; the other numbers are that path's comparisons.  The last line
is ``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ITERS = 10
REPEATS = 25
SEGSUM_RTOL = 1e-5
# the blocked sweeps against their plain versions: each entry within this
# share of the largest |entry|.  Both sum in exact fp32 in other orders
# (warp butterflies against cuBLAS), and a rounding difference in one
# stripe's result feeds every later stripe through L's off-diagonal
# blocks, so the gap grows with the stripe count and L's conditioning
# (the equilibrated Schur factor, K = 6 at kitti07, 33 at n = 8448).
SOLVE_RTOL = 1e-4
TRAJ_RTOL = 5e-3

KITTI = dict(num_poses=1322, num_landmarks=133383, mean_obs_per_landmark=5.5,
             stereo_fraction=0.25, seed=0, loop_closure=True)  # bench.py:121-137
KITTI_BAND_M = 22
KITTI07 = dict(num_poses=248, num_landmarks=26127, mean_obs_per_landmark=4.65,
               stereo_fraction=0.25, seed=0, loop_closure=False)  # bench.py:114-119
TRISOLVE_KERNELS = ("extract_diag_blocks", "solve_lower", "solve_upper", "matvec")
REPLACES = {
    "resident_gather": "cuba_tpu/ops/segmm.py:1257",
    "windowed_gather": "cuba_tpu/ops/segmm.py:1215",
    "tiled_gather": "cuba_tpu/ops/segmm.py:487",
    "accum_segsum_windowed": "cuba_tpu/ops/segmm.py:205",
    "tiled_segsum": "cuba_tpu/ops/segmm.py:425",
    "accum_segsum": "cuba_tpu/ops/segmm.py:105",
    "schur_fused": "cuba_tpu/ops/segmm.py:798",
    "compact_to_band": "cuba_tpu/ops/segmm.py:1093",
    "compact_to_dense": "cuba_tpu/ops/segmm.py:964",
    "extract_diag_blocks": "cuba_tpu/solver/trisolve.py:74",
    "solve_lower": "cuba_tpu/solver/trisolve.py:120",
    "solve_upper": "cuba_tpu/solver/trisolve.py:159",
    "matvec": "cuba_tpu/solver/trisolve.py:200",
}


def kernel_source(name: str) -> str:
    return "cuba_tpu_torch/csrc/" + ("trisolve.cu" if name in TRISOLVE_KERNELS else "segmm.cu")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def make_graph(prob, config):
    from cuba_tpu_torch import EdgeType, RobustKernelType
    from cuba_tpu_torch.io import synthetic

    ba = synthetic.build_graph(prob, config)
    ba.set_robust_kernels(RobustKernelType.HUBER, float(np.sqrt(5.991)), EdgeType.MONOCULAR)
    ba.set_robust_kernels(RobustKernelType.HUBER, float(np.sqrt(7.815)), EdgeType.STEREO)
    return ba


def cuda_ms(fn, torch) -> float:
    """Median milliseconds of ``fn()`` over REPEATS CUDA-event-timed runs."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def check_kernels(engine, torch, segmm):
    """Phase 2: each wrapper's kernel against its plain version on the
    slice's tensors.  Returns {name: (max_abs_err, ms, plain_ms)}."""
    from cuba_tpu_torch.solver import edgerows, rows

    plan, rc = engine.plan, engine.rc
    st = engine.state
    total_p = st.qs.shape[0]
    psrc = torch.zeros((12, plan.p_res_pad), dtype=torch.float32, device=st.qs.device)
    psrc[:, :total_p] = torch.cat([st.qs, st.ts, engine.cams], dim=1).T
    pack_m, _pack_s, _chi = engine._residuals_and_chi(st)
    g12, err, Xc, inv_z = pack_m
    R = edgerows.rotmat_rows(g12[0:4])
    v42, v12, v18 = edgerows.term_rows(err, Xc, R, inv_z, g12[7:12], rc.omegaT_m,
                                       engine.kernels[0], 2)
    HppT, HllT, HplT = engine._build(*engine._residuals_and_chi(st)[:2])
    lam = torch.ones((), dtype=torch.float32, device=st.qs.device)
    iv9 = rows.prepare_factors(HppT, HllT, HplT, lam, engine.num_p, engine.num_l, plan, rc)[0]
    src12 = torch.cat([iv9, HllT[9:12]])
    if plan.rg_m is not None:
        wsrc, wids = psrc.index_select(1, rc.res_perm), rc.pose_gidr_m
    else:
        wsrc, wids = psrc, rc.pose_gid_m
    paw = plan.paw_m
    cases = {
        "resident_gather": (
            "exact", lambda f: f(psrc, rc.pose_gid_m),
            segmm.resident_gather, segmm.resident_gather_plain),
        "windowed_gather": (
            "exact", lambda f: f(wsrc, wids, plan.rg_m, None),
            segmm.windowed_gather, segmm.windowed_gather_plain),
        "tiled_gather": (
            "exact", lambda f: f(src12, rc.hpl_col, plan.ivs, None),
            segmm.tiled_gather, segmm.tiled_gather_plain),
        "accum_segsum_windowed": (
            (v42, rc.pose_acc_m, engine.num_p),
            lambda f: f(v42, rc.pose_acc_m, engine.num_p, paw, None, csr=rc.csr_pose_m),
            segmm.accum_segsum_windowed, segmm.accum_segsum_windowed_plain),
        "tiled_segsum": (
            (v18, rc.e2h_m, plan.hpl_pad),
            lambda f: f(v18, rc.e2h_m, plan.hpl_pad, plan.hpl_m, None, csr=rc.csr_e2h_m),
            segmm.tiled_segsum, segmm.tiled_segsum_plain),
        "accum_segsum": (
            (v42, rc.pose_acc_m, engine.num_p),
            lambda f: f(v42, rc.pose_acc_m, engine.num_p, csr=rc.csr_pose_m),
            segmm.accum_segsum, segmm.accum_segsum_plain),
    }
    return compare_cases(cases, torch, lambda *kind: segsum_bound(segmm, *kind))


def segsum_bound(segmm, vals, ids, num_out):
    """A segment sum's bound: SEGSUM_RTOL times each output's sum of |vals|."""
    return SEGSUM_RTOL * segmm.accum_segsum_plain(vals.abs(), ids, num_out)


def compare_cases(cases, torch, bound_of):
    """Each case's kernel against its plain version: equal bit for bit
    ("exact"), or within ``bound_of(*kind)`` elementwise.  A case's label is
    the wrapper's name, with ``:site`` where one wrapper has two call sites.
    Returns {label: (max_abs_err, ms, plain_ms)}."""
    out = {}
    for name, (kind, call, kern, plain) in cases.items():
        got = call(kern)
        torch.cuda.synchronize()
        ref = call(plain)
        if got.shape != ref.shape or got.dtype != torch.float32:
            fail(f"{name}: kernel gave {tuple(got.shape)} {got.dtype}, "
                 f"plain {tuple(ref.shape)} {ref.dtype}")
        diff = (got - ref).abs()
        if kind == "exact":
            if not torch.equal(got, ref):
                fail(f"{name}: kernel and plain results differ (max {float(diff.max())})")
        elif not bool((diff <= bound_of(*kind)).all()):
            fail(f"{name}: kernel and plain sums differ beyond the stated bound "
                 f"(max abs diff {float(diff.max())})")
        ms = cuda_ms(lambda: call(kern), torch)
        plain_ms = cuda_ms(lambda: call(plain), torch)
        out[name] = (float(diff.max()) if diff.numel() else 0.0, ms, plain_ms)
        log(f"kernel {name}: shape {tuple(got.shape)} max_abs_err {out[name][0]:.3e} "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
    return out


def first_attempt(engine):
    """The first damped attempt's (HppT, HplT, lam, W, bscT) on the
    engine's initial state."""
    from cuba_tpu_torch.solver import rows

    plan, rc = engine.plan, engine.rc
    HppT, HllT, HplT = engine._build(*engine._residuals_and_chi(engine.state)[:2])
    lam = engine.config.tau * rows.max_diagonal_T(HppT, HllT)
    _iv9, W, bscT, _g12 = rows.prepare_factors(HppT, HllT, HplT, lam, engine.num_p,
                                               engine.num_l, plan, rc)
    return HppT, HplT, lam, W.contiguous(), bscT


def check_schur_kernels(engine, torch, segmm, HplT, W):
    """Kernels 1-6 at the call sites of phase 2, ``tiled_segsum`` at the
    combine of ``rows.schur_compact``, and ``schur_fused``."""
    out = check_kernels(engine, torch, segmm)
    plan, rc = engine.plan, engine.rc
    sc = (plan.schur, rc.sc_sb, rc.sc_li, rc.sc_lj, rc.sc_lk)
    M = plan.pad_blocks // 64
    # the combine's input as rows.schur_compact makes it
    win = segmm.schur_fused(W, HplT, *sc, csr=rc.csr_sc)
    win = torch.nn.functional.pad(win, (0, plan.wpad - win.shape[1]))
    cases = {
        "schur_fused": (
            ("schur",), lambda f: f(W, HplT, *sc, csr=rc.csr_sc),
            segmm.schur_fused, segmm.schur_fused_plain),
        "tiled_segsum:combine": (
            (win, rc.gkey_up2, M * plan.wg),
            lambda f: f(win, rc.gkey_up2, M * plan.wg, plan.up2, plan.up2.base_block,
                        csr=rc.csr_up2),
            segmm.tiled_segsum, segmm.tiled_segsum_plain),
    }

    def bound_of(*kind):
        if kind == ("schur",):
            return SEGSUM_RTOL * segmm.schur_fused_plain(W.abs(), HplT.abs(), *sc)
        return segsum_bound(segmm, *kind)

    out.update(compare_cases(cases, torch, bound_of))
    return out


def check_band_kernels(engine, torch, segmm):
    """Phase 6: every kernel of the band path against its plain version on
    the band run's plan and first-attempt tensors: kernels 1-7 (as
    :func:`check_schur_kernels`) and ``compact_to_band``; then the CR factor
    + solve timed with each diagonal-block inverse.  Returns the kernel
    entries."""
    from cuba_tpu_torch.solver import band_cr, rows

    plan, rc = engine.plan, engine.rc
    HppT, HplT, lam, W, bscT = first_attempt(engine)
    out = check_schur_kernels(engine, torch, segmm, HplT, W)
    PB = plan.pad_blocks
    gT = rows.schur_compact(W, HplT, plan, rc)
    dbT = rows.damped_diagonal_T(HppT, lam, engine.num_p, PB)
    band_args = (gT, rc.iru, rc.icu, dbT, rc.band_occ, PB, plan.wg)
    out.update(compare_cases({"compact_to_band": (
        "exact", lambda f: f(*band_args, table=rc.band_table),
        segmm.compact_to_band, segmm.compact_to_band_plain)}, torch, None))

    D, U = rows.band_from_compact(gT, HppT, lam, engine.num_p, plan, rc)
    rhs = bscT.new_zeros(6 * PB)
    rhs[:6 * engine.num_p] = bscT.T.reshape(-1)
    xs = {}
    for name, inv in (("_inv_spd_rs", band_cr._inv_spd_rs),
                      ("_inv_spd_chol", band_cr._inv_spd_chol)):
        x, ok, _reads = band_cr.cr_solve(D, U, rhs, engine.config.refinement_steps, inv=inv)
        if not bool(ok):
            fail(f"cr_solve with {name} rejected the first attempt's band")
        xs[name] = x
        ms = cuda_ms(lambda: band_cr.cr_solve(D, U, rhs, engine.config.refinement_steps,
                                              inv=inv), torch)
        log(f"CR factor+solve (m {D.shape[0]}, 1 refinement sweep) with {name}: {ms:.4f} ms")
    rel = float((xs["_inv_spd_rs"] - xs["_inv_spd_chol"]).abs().max()
                / xs["_inv_spd_chol"].abs().max())
    log(f"CR solutions, _inv_spd_rs vs _inv_spd_chol: max rel diff {rel:.3e}")
    return out


def check_dense_kernels(engine, torch, segmm, label, schur_kernels=True):
    """Phase 9: every kernel of the dense path against its plain version on
    the engine's plan and first-attempt tensors (kernels 1-7 as
    :func:`check_schur_kernels` with ``schur_kernels``, then kernels 9 and
    11-14), the whole ``cholesky_solve`` against the same call under
    ``use_plain()``, and the two sweeps against ``torch.linalg.
    solve_triangular``.  Returns the kernel entries."""
    from cuba_tpu_torch.solver import dense_cholesky, rows, trisolve

    plan, rc = engine.plan, engine.rc
    HppT, HplT, lam, W, bscT = first_attempt(engine)
    out = check_schur_kernels(engine, torch, segmm, HplT, W) if schur_kernels else {}
    PB = plan.pad_blocks
    gT = rows.schur_compact(W, HplT, plan, rc)
    dbT = rows.damped_diagonal_T(HppT, lam, engine.num_p, PB)
    dense_args = (gT, rc.iru, rc.icu, dbT, rc.occ2, PB, plan.wg)
    A = segmm.compact_to_dense(*dense_args, table=rc.dense_table)
    n = A.shape[0]
    rhs = bscT.new_zeros(n)
    rhs[:6 * engine.num_p] = bscT.T.reshape(-1)
    s = torch.rsqrt(torch.clamp(torch.diagonal(A), min=1e-30))
    L, reads = dense_cholesky.factor(A * s[:, None] * s[None, :])
    if not bool(torch.isfinite(L).all()):
        fail(f"{label}: the first attempt's dense system did not factor")
    invd = trisolve.prepare(L)
    b = (rhs * s).contiguous()
    y = trisolve.solve_lower(L, invd, b)
    z = trisolve.solve_upper(L, invd, y)
    x = (s * z).contiguous()
    cases = {
        "compact_to_dense": (
            "exact", lambda f: f(*dense_args, table=rc.dense_table),
            segmm.compact_to_dense, segmm.compact_to_dense_plain),
        "extract_diag_blocks": (
            "exact", lambda f: f(L), trisolve.extract_diag_blocks,
            trisolve.extract_diag_blocks_plain),
        "solve_lower": (
            ("solve", y), lambda f: f(L, invd, b), trisolve.solve_lower,
            trisolve.solve_lower_plain),
        "solve_upper": (
            ("solve", z), lambda f: f(L, invd, y), trisolve.solve_upper,
            trisolve.solve_upper_plain),
        "matvec": (
            ("matvec",), lambda f: f(A, x), trisolve.matvec, trisolve.matvec_plain),
    }

    def bound_of(*kind):
        if kind[0] == "solve":
            return SOLVE_RTOL * kind[1].abs().max()
        return SEGSUM_RTOL * (A.abs() @ x.abs())

    out.update(compare_cases(cases, torch, bound_of))

    refine = engine.config.refinement_steps + 1  # as the engine runs it on the card
    ms = cuda_ms(lambda: dense_cholesky.cholesky_solve(A, rhs, refine, use_kernels=True), torch)
    with segmm.use_plain():
        plain_ms = cuda_ms(lambda: dense_cholesky.cholesky_solve(A, rhs, refine,
                                                                 use_kernels=True), torch)
    tri_ms = cuda_ms(lambda: torch.linalg.solve_triangular(
        L.mT, torch.linalg.solve_triangular(L, b[:, None], upper=False), upper=True), torch)
    fac_ms = cuda_ms(lambda: dense_cholesky.factor(A * s[:, None] * s[None, :]), torch)
    log(f"{label}: cholesky_solve (n {n}, {refine} refinement sweeps): kernels {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms; equilibrate + factor {fac_ms:.4f} ms ({reads} host read); "
        f"kernel sweeps lower + upper {out['solve_lower'][1] + out['solve_upper'][1]:.4f} ms "
        f"against torch.linalg.solve_triangular lower + upper {tri_ms:.4f} ms")
    return out


def dense_attempt_phases(engine, torch):
    """One damped attempt of the dense path on the engine's initial state,
    phase by phase: median CUDA-event ms of each phase run alone."""
    from cuba_tpu_torch.solver import dense_cholesky, rows, trisolve

    plan, rc, P = engine.plan, engine.rc, engine.num_p
    st = engine.state
    pack_m, pack_s, _chi = engine._residuals_and_chi(st)
    HppT, HllT, HplT = engine._build(pack_m, pack_s)
    lam = engine.config.tau * rows.max_diagonal_T(HppT, HllT)
    iv9, W, bscT, g12 = rows.prepare_factors(HppT, HllT, HplT, lam, P, engine.num_l, plan, rc)
    gT = rows.schur_compact(W, HplT, plan, rc)
    A = rows.dense_from_compact(gT, HppT, lam, P, plan, rc)
    n = A.shape[0]
    rhs = bscT.new_zeros(n)
    rhs[:6 * P] = bscT.T.reshape(-1)
    s = torch.rsqrt(torch.clamp(torch.diagonal(A), min=1e-30))
    L, _ = dense_cholesky.factor(A * s[:, None] * s[None, :])
    invd = trisolve.prepare(L)

    def solve_with(v):
        return s * trisolve.solve_upper(L, invd, trisolve.solve_lower(L, invd, v * s))

    x = solve_with(rhs)
    xp = x[:6 * P].reshape(P, 6)
    xl = rows.back_substitute(iv9, HllT, HplT, g12, xp, engine.num_l, plan, rc)
    phases = {
        "edge_rows": lambda: engine._residuals_and_chi(st),
        "build_system": lambda: engine._build(pack_m, pack_s),
        "prepare_factors": lambda: rows.prepare_factors(HppT, HllT, HplT, lam, P,
                                                        engine.num_l, plan, rc),
        "schur_compact": lambda: rows.schur_compact(W, HplT, plan, rc),
        "dense_from_compact": lambda: rows.dense_from_compact(gT, HppT, lam, P, plan, rc),
        "equilibrate+factor": lambda: dense_cholesky.factor(A * s[:, None] * s[None, :]),
        "trisolve.prepare": lambda: trisolve.prepare(L),
        "first solve": lambda: solve_with(rhs),
        "one refinement sweep": lambda: x + solve_with(rhs - trisolve.matvec(A, x)),
        "back_substitute": lambda: rows.back_substitute(iv9, HllT, HplT, g12, xp,
                                                        engine.num_l, plan, rc),
        "update+trial residuals": lambda: engine._residuals_and_chi(
            engine._apply_update(st, xp, xl)),
    }
    times = {name: cuda_ms(fn, torch) for name, fn in phases.items()}
    log("dense attempt phases (ms, median of 25, each alone): "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
        + f"; sum {sum(times.values()):.4f} with "
        f"{engine.config.refinement_steps + 1} refinement sweeps counted once")


def run_path(prob, config, torch, label):
    """initialize() + optimize(ITERS) through the public API, timed."""
    ba = make_graph(prob, config)
    t0 = time.perf_counter()
    ba.initialize()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    ba.optimize(ITERS)
    torch.cuda.synchronize()
    t_opt = time.perf_counter() - t0
    r = ba.last_result
    chis = np.array([s.chi2 for s in ba.batch_statistics()])
    log(f"{label}: solver {ba._engine.solver}, band_m {ba._engine.band_m}")
    log(f"{label}: initialize {t_init:.4f} s, optimize({ITERS}) {t_opt:.4f} s, "
        f"niters {r.niters}, attempts {r.nattempts}, cg_steps {r.cg_steps}, "
        f"host_reads {r.host_reads}")
    log(f"{label}: chi2 per iteration {chis.tolist()}")
    if chis.size == 0 or not np.all(np.isfinite(chis)):
        fail(f"{label}: chi2 trajectory not finite: {chis.tolist()}")
    qs = ba._state.qs
    if not bool(torch.isfinite(qs).all()) or tuple(qs.shape) != (ba._engine.structure.total_p, 4):
        fail(f"{label}: pose estimates not finite or of the wrong shape")
    return ba, chis, t_init, t_opt


def expected_kernels(engine):
    """The kernel wrappers an engine's plan and solver route the LM loop
    through."""
    from cuba_tpu_torch.solver import trisolve

    plan = engine.plan
    expected = {"tiled_gather", "tiled_segsum",
                "windowed_gather" if plan.rg_m is not None else "resident_gather"}
    for paw in (plan.paw_m, plan.paw_s, plan.paw_b):
        expected.add("accum_segsum_windowed" if paw.ok else "accum_segsum")
    if engine.solver == "band_cr":
        expected |= {"schur_fused", "compact_to_band"}
    elif engine.solver == "dense_cholesky":
        expected |= {"schur_fused", "compact_to_dense"}
        if trisolve.usable(6 * engine.pad_blocks, engine.dtype):
            expected |= {"extract_diag_blocks", "solve_lower", "solve_upper"}
            if engine.config.refinement_steps > 0:
                expected.add("matvec")
    return expected


def compare_trajectories(chis, chis_plain, label):
    n = min(len(chis), len(chis_plain))
    if n < 2 or len(chis) != len(chis_plain):
        fail(f"{label}: trajectories differ in length: {len(chis)} vs {len(chis_plain)}")
    rel = np.abs(chis[:n] - chis_plain[:n]) / np.abs(chis_plain[:n])
    log(f"{label}: kernel vs plain chi2: max rel diff {rel.max():.3e} (rtol {TRAJ_RTOL})")
    if not np.all(rel <= TRAJ_RTOL):
        fail(f"{label}: kernel and plain chi2 trajectories disagree")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num-poses", type=int, default=4096)
    args = ap.parse_args()

    sys.path.insert(0, HERE)
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs an NVIDIA GPU")
    try:
        import cuba_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"cuba_tpu_torch is not importable next to chip_smoke.py ({e})")
    from cuba_tpu_torch import BAConfig, native
    from cuba_tpu_torch.io import synthetic
    from cuba_tpu_torch.ops import segmm

    # phase 1: device and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    try:
        build_s = segmm.build_kernels()
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        fail(f"kernel build failed: {e}")
    log(f"nvcc builds of cuba_tpu_torch/csrc/segmm.cu and trisolve.cu (in parallel): "
        f"{build_s:.2f} s")
    log(f"symbolic pass: {native.backend()}")

    num_p = args.num_poses
    num_l = 15 * num_p
    prob = synthetic.generate(
        num_poses=num_p, num_landmarks=num_l, mean_obs_per_landmark=5.0,
        stereo_fraction=0.25, seed=0,
        init_rot_noise=0.002, init_trans_noise=0.02, init_point_noise=0.04,
    )
    n_edges = prob.mono_p.size + prob.stereo_p.size
    log(f"problem: P {num_p}, L {num_l}, E {n_edges} "
        f"({prob.stereo_p.size} stereo), bench_pcg_crossover parameters, seed 0")
    config = BAConfig(dtype=torch.float32, solver="pcg", device="cuda")

    # warm-up run (also the engine whose tables phase 2 uses)
    ba, _chis, t_init0, t_opt0 = run_path(prob, config, torch, "warm-up")
    engine = ba._engine

    # phase 2: kernels against plain versions
    kern_pcg = check_kernels(engine, torch, segmm)
    del ba, engine

    # phase 3: the PCG path, counted and timed
    segmm.reset_launches()
    ba, chis, t_init, t_opt = run_path(prob, config, torch, "pcg path")
    launches_pcg = dict(segmm.LAUNCHES)
    log(f"launches (pcg path): {json.dumps(launches_pcg)}")
    if not chis[-1] < chis[0]:
        fail(f"chi2 did not fall: {chis[0]} -> {chis[-1]}")
    missing = sorted(n for n in expected_kernels(ba._engine) if launches_pcg[n] == 0)
    if missing:
        fail(f"kernels of the pcg path never launched: {missing}")
    del ba

    # phase 4: the same run with the plain versions on the card
    with segmm.use_plain():
        _ba, chis_plain, _ti, t_opt_plain = run_path(prob, config, torch, "pcg plain path")
    compare_trajectories(chis, chis_plain, "pcg")
    log(f"pcg walls ({card}): initialize {t_init} s, optimize({ITERS}) {t_opt} s; cold "
        f"initialize {t_init0} s, optimize {t_opt0} s; plain optimize {t_opt_plain} s")
    del _ba

    # phase 5: the band path (solver="auto") on the kitti00-scale loop graph
    from bench import CHI2_FP64_FINAL, CHI2_REL_BAND

    kprob = synthetic.generate(**KITTI)
    log(f"kitti00 loop: P {KITTI['num_poses']}, L {KITTI['num_landmarks']}, "
        f"E {kprob.mono_p.size + kprob.stereo_p.size} ({kprob.stereo_p.size} stereo), "
        "bench.py parameters, seed 0")
    kconfig = BAConfig(dtype=torch.float32, device="cuda")
    kba, _kchis, kt_init0, kt_opt0 = run_path(kprob, kconfig, torch, "kitti warm-up")
    kengine = kba._engine
    if kengine.solver != "band_cr" or kengine.band_m != KITTI_BAND_M:
        fail(f"solver='auto' resolved to {kengine.solver!r} with band_m {kengine.band_m}, "
             f"expected 'band_cr' with {KITTI_BAND_M}")

    # phase 6: the band path's kernels against their plain versions, CR timings
    kern_band = check_band_kernels(kengine, torch, segmm)
    del kba, kengine

    segmm.reset_launches()
    kba, kchis, kt_init, kt_opt = run_path(kprob, kconfig, torch, "band path")
    launches_band = dict(segmm.LAUNCHES)
    log(f"launches (band path): {json.dumps(launches_band)}")
    if not (kchis[-1] < kchis[0] and np.all(np.diff(kchis) <= 0)):
        fail(f"kitti00 chi2 did not fall: {kchis.tolist()}")
    ref = CHI2_FP64_FINAL[("kitti00_scale_loop", ITERS)]
    rel = abs(kchis[-1] - ref) / ref
    log(f"kitti00 final chi2 {kchis[-1]:.2f} vs fp64 record {ref:.2f}: rel {rel:.3e} "
        f"(band {CHI2_REL_BAND})")
    if not rel < CHI2_REL_BAND:
        fail("kitti00 final chi2 is outside the recorded fp64 band")
    missing = sorted(n for n in expected_kernels(kba._engine) if launches_band[n] == 0)
    if missing:
        fail(f"kernels of the band path never launched: {missing}")
    del kba

    # phase 7: the band run with the plain versions on the card
    with segmm.use_plain():
        _kba, kchis_plain, kt_init_p, kt_opt_plain = run_path(kprob, kconfig, torch,
                                                              "band plain path")
    compare_trajectories(kchis, kchis_plain, "band")
    log(f"band walls ({card}): initialize {kt_init} s, optimize({ITERS}) {kt_opt} s; cold "
        f"initialize {kt_init0} s, optimize {kt_opt0} s; plain initialize {kt_init_p} s, "
        f"plain optimize {kt_opt_plain} s")
    del _kba

    # phase 8: the dense path (solver="auto") on the kitti07-scale graph
    dprob = synthetic.generate(**KITTI07)
    log(f"kitti07: P {KITTI07['num_poses']}, L {KITTI07['num_landmarks']}, "
        f"E {dprob.mono_p.size + dprob.stereo_p.size} ({dprob.stereo_p.size} stereo), "
        "bench.py --quick parameters, seed 0")
    dba, _dchis, dt_init0, dt_opt0 = run_path(dprob, kconfig, torch, "kitti07 warm-up")
    dengine = dba._engine
    if dengine.solver != "dense_cholesky":
        fail(f"solver='auto' resolved to {dengine.solver!r} on kitti07, "
             "expected 'dense_cholesky'")

    # phase 9: the dense path's kernels against their plain versions
    kern_dense = check_dense_kernels(dengine, torch, segmm, "kitti07")
    dense_attempt_phases(dengine, torch)
    del dba, dengine

    segmm.reset_launches()
    dba, dchis, dt_init, dt_opt = run_path(dprob, kconfig, torch, "dense path")
    launches_dense = dict(segmm.LAUNCHES)
    log(f"launches (dense path): {json.dumps(launches_dense)}")
    if not (dchis[-1] < dchis[0] and np.all(np.diff(dchis) <= 0)):
        fail(f"kitti07 chi2 did not fall: {dchis.tolist()}")
    ref = CHI2_FP64_FINAL[("kitti07_scale", ITERS)]
    rel = abs(dchis[-1] - ref) / ref
    log(f"kitti07 final chi2 {dchis[-1]:.2f} vs fp64 record {ref:.2f}: rel {rel:.3e} "
        f"(band {CHI2_REL_BAND})")
    if not rel < CHI2_REL_BAND:
        fail("kitti07 final chi2 is outside the recorded fp64 band")
    missing = sorted(n for n in expected_kernels(dba._engine) if launches_dense[n] == 0)
    if missing:
        fail(f"kernels of the dense path never launched: {missing}")
    del dba

    # phase 9, kitti00: the dense solver on the loop graph (n = 8448)
    xconfig = BAConfig(dtype=torch.float32, device="cuda", solver="dense_cholesky")
    xba = make_graph(kprob, xconfig)
    t0 = time.perf_counter()
    xba.initialize()
    torch.cuda.synchronize()
    log(f"kitti00 dense: initialize {time.perf_counter() - t0:.4f} s, "
        f"n {6 * xba._engine.pad_blocks}")
    kern_dense00 = check_dense_kernels(xba._engine, torch, segmm, "kitti00 dense",
                                       schur_kernels=False)
    del xba
    segmm.reset_launches()
    _xba, xchis, _xt_init, xt_opt = run_path(kprob, xconfig, torch, "kitti00 dense path")
    launches_dense00 = dict(segmm.LAUNCHES)
    if not (xchis[-1] < xchis[0] and np.all(np.diff(xchis) <= 0)):
        fail(f"kitti00 dense chi2 did not fall: {xchis.tolist()}")
    ref00 = CHI2_FP64_FINAL[("kitti00_scale_loop", ITERS)]
    log(f"kitti00 dense final chi2 {xchis[-1]:.2f} (band path {kchis[-1]:.2f}, fp64 record "
        f"{ref00:.2f}: rel {abs(xchis[-1] - ref00) / ref00:.3e}; not gated), "
        f"optimize({ITERS}) {xt_opt:.4f} s")
    del _xba

    # phase 10: the dense run with the plain versions on the card
    with segmm.use_plain():
        _dba, dchis_plain, dt_init_p, dt_opt_plain = run_path(dprob, kconfig, torch,
                                                              "dense plain path")
    compare_trajectories(dchis, dchis_plain, "dense")
    log(f"dense walls ({card}): initialize {dt_init} s, optimize({ITERS}) {dt_opt} s; cold "
        f"initialize {dt_init0} s, optimize {dt_opt0} s; plain initialize {dt_init_p} s, "
        f"plain optimize {dt_opt_plain} s")
    del _dba

    entries = []
    for path, kern, launches in (("pcg", kern_pcg, launches_pcg),
                                 ("band", kern_band, launches_band),
                                 ("dense", kern_dense, launches_dense),
                                 ("dense-kitti00", kern_dense00, launches_dense00)):
        for label, (err, ms, plain_ms) in kern.items():
            name, _, site = label.partition(":")
            entries.append({"name": name, "path": path, **({"site": site} if site else {}),
                            "route": "cuda", "source": kernel_source(name),
                            "replaces": REPLACES[name], "launches": launches[name],
                            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
