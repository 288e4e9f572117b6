#!/usr/bin/env python3
"""Drive cuba_tpu_torch's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--num-poses 4096]

Phases (any failure exits non-zero, before the result line):

1. Device and build: the card's name and power limit, the torch and CUDA
   versions, the nvcc build of ``cuba_tpu_torch/csrc/segmm.cu`` (timed) and
   which symbolic pass (C++ or NumPy) the host runs.
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

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
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
TRAJ_RTOL = 5e-3

KERNEL_SOURCE = "cuba_tpu_torch/csrc/segmm.cu"
REPLACES = {
    "resident_gather": "cuba_tpu/ops/segmm.py:1257",
    "windowed_gather": "cuba_tpu/ops/segmm.py:1215",
    "tiled_gather": "cuba_tpu/ops/segmm.py:487",
    "accum_segsum_windowed": "cuba_tpu/ops/segmm.py:205",
    "tiled_segsum": "cuba_tpu/ops/segmm.py:425",
    "accum_segsum": "cuba_tpu/ops/segmm.py:105",
}


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
    psrc = torch.zeros((12, plan.p_res_pad), dtype=torch.float32, device="cuda")
    psrc[:, :total_p] = torch.cat([st.qs, st.ts, engine.cams], dim=1).T
    pack_m, _pack_s, _chi = engine._residuals_and_chi(st)
    g12, err, Xc, inv_z = pack_m
    R = edgerows.rotmat_rows(g12[0:4])
    v42, v12, v18 = edgerows.term_rows(err, Xc, R, inv_z, g12[7:12], rc.omegaT_m,
                                       engine.kernels[0], 2)
    HppT, HllT, HplT = engine._build(*engine._residuals_and_chi(st)[:2])
    lam = torch.ones((), dtype=torch.float32, device="cuda")
    iv9 = rows.prepare_factors(HppT, HllT, HplT, lam, engine.num_p, engine.num_l, plan, rc)[0]
    src12 = torch.cat([iv9, HllT[9:12]])
    if plan.rg_m is not None:
        wsrc, wids = psrc.index_select(1, rc.res_perm), rc.pose_gidr_m
    else:
        wsrc, wids = psrc, rc.pose_gid_m
    paw = plan.paw_m
    cases = {
        "resident_gather": (
            "gather", lambda f: f(psrc, rc.pose_gid_m),
            segmm.resident_gather, segmm.resident_gather_plain),
        "windowed_gather": (
            "gather", lambda f: f(wsrc, wids, plan.rg_m, None),
            segmm.windowed_gather, segmm.windowed_gather_plain),
        "tiled_gather": (
            "gather", lambda f: f(src12, rc.hpl_col, plan.ivs, None),
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
    out = {}
    for name, (kind, call, kern, plain) in cases.items():
        got = call(kern)
        torch.cuda.synchronize()
        ref = call(plain)
        if got.shape != ref.shape or got.dtype != torch.float32:
            fail(f"{name}: kernel gave {tuple(got.shape)} {got.dtype}, "
                 f"plain {tuple(ref.shape)} {ref.dtype}")
        diff = (got - ref).abs()
        if kind == "gather":
            if not torch.equal(got, ref):
                fail(f"{name}: kernel and plain gathers differ (max {float(diff.max())})")
        else:
            vals, ids, num_out = kind
            bound = SEGSUM_RTOL * segmm.accum_segsum_plain(vals.abs(), ids, num_out)
            if not bool((diff <= bound).all()):
                fail(f"{name}: kernel and plain sums differ beyond {SEGSUM_RTOL} of sum|vals| "
                     f"(max abs diff {float(diff.max())})")
        ms = cuda_ms(lambda: call(kern), torch)
        plain_ms = cuda_ms(lambda: call(plain), torch)
        out[name] = (float(diff.max()) if diff.numel() else 0.0, ms, plain_ms)
        log(f"kernel {name}: shape {tuple(got.shape)} max_abs_err {out[name][0]:.3e} "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
    return out


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
    log(f"nvcc build of {KERNEL_SOURCE}: {build_s:.2f} s")
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
    kern = check_kernels(engine, torch, segmm)
    del ba, engine

    # phase 3: the main path, counted and timed
    segmm.reset_launches()
    ba, chis, t_init, t_opt = run_path(prob, config, torch, "main path")
    launches = dict(segmm.LAUNCHES)
    log(f"launches: {json.dumps(launches)}")
    if not chis[-1] < chis[0]:
        fail(f"chi2 did not fall: {chis[0]} -> {chis[-1]}")
    plan = ba._engine.plan
    expected = {"tiled_gather", "tiled_segsum",
                "windowed_gather" if plan.rg_m is not None else "resident_gather"}
    for paw in (plan.paw_m, plan.paw_s, plan.paw_b):
        expected.add("accum_segsum_windowed" if paw.ok else "accum_segsum")
    missing = sorted(n for n in expected if launches[n] == 0)
    if missing:
        fail(f"kernels of the path never launched: {missing}")
    del ba

    # phase 4: the same run with the plain versions on the card
    with segmm.use_plain():
        _ba, chis_plain, _ti, t_opt_plain = run_path(prob, config, torch, "plain path")
    n = min(len(chis), len(chis_plain))
    if n < 2 or len(chis) != len(chis_plain):
        fail(f"trajectories differ in length: {len(chis)} vs {len(chis_plain)}")
    rel = np.abs(chis[:n] - chis_plain[:n]) / np.abs(chis_plain[:n])
    log(f"kernel vs plain chi2: max rel diff {rel.max():.3e} (rtol {TRAJ_RTOL}); "
        f"optimize kernel {t_opt:.4f} s plain {t_opt_plain:.4f} s")
    if not np.all(rel <= TRAJ_RTOL):
        fail("kernel and plain chi2 trajectories disagree")

    log(f"walls ({card}): initialize {t_init} s, optimize({ITERS}) {t_opt} s; cold "
        f"initialize {t_init0} s, optimize {t_opt0} s; plain optimize {t_opt_plain} s")
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        for name, (err, ms, plain_ms) in kern.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
