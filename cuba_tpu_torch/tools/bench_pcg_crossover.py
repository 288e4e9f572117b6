"""The reduced solvers against each other as P grows: dense Cholesky, band
cyclic reduction and the matrix-free block-Jacobi PCG on the same
pose-heavy synthetic problems, and the smallest P at which a scalable
solver beats the dense one.

    python -m cuba_tpu_torch.tools.bench_pcg_crossover
        [--scales 2048,4096,8192,16384] [--iters 3] [--trials 2]
        [--lm-per-pose 15] [--dtype float32] [--device cuda|cpu]

Each problem: P poses, P * lm-per-pose landmarks, ~5 observations each,
25% stereo, seed 0, with the gentler initial noise (at P >= 4096 the
default drift starts LM so far from the basin that fp32 rejects the first
steps).  Per (P, solver): a warm-up engine and ``optimize(iters)``, then
the least over ``trials`` of a fresh engine plus ``optimize(iters)``,
ending in a synchronize.  One JSON line per (P, solver), then the summary
line.  The dense solver's memory grows as (6 PB)^2: where the card runs
out of memory (``torch.cuda.OutOfMemoryError``), that row carries the
error and the sweep goes on; any other error ends the run.  On the card by
default; without one it fails (pass ``--device cpu`` for the host).
"""

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch

from cuba_tpu_torch.config import BAConfig
from cuba_tpu_torch.io import synthetic
from cuba_tpu_torch.solver.engine import BlockSolverEngine
from cuba_tpu_torch.tools import graphs

SOLVERS = ("dense_cholesky", "band_cr", "pcg")


def run_one(num_p, num_l, mean_obs, solver, iters, trials, device, dtype):
    """One row: the least wall of engine construction + optimize(iters)."""
    prob = synthetic.generate(
        num_poses=num_p, num_landmarks=num_l, mean_obs_per_landmark=mean_obs,
        stereo_fraction=0.25, seed=0, **graphs.GENTLE_NOISE)
    s = graphs.structure_of(prob)
    config = BAConfig(dtype=getattr(torch, dtype), solver=solver, device=device)
    nedges = prob.mono_p.size + prob.stereo_p.size
    del prob
    engine = BlockSolverEngine(s, graphs.KERNELS, config)
    res = engine.optimize(engine.state, iters)
    graphs.sync(device)
    chis = np.asarray(res.chis, np.float64)
    elapsed = float("inf")
    for _ in range(trials):
        del engine, res
        t0 = time.perf_counter()
        engine = BlockSolverEngine(s, graphs.KERNELS, config)
        res = engine.optimize(engine.state, iters)
        graphs.sync(device)
        elapsed = min(elapsed, time.perf_counter() - t0)
    return dict(P=num_p, L=num_l, E=int(nedges), solver=solver, route=engine.path,
                pad_blocks=engine.pad_blocks, iters=iters, attempts=int(res.nattempts),
                wall_s=elapsed, chi0=float(chis[0]), chiN=float(chis[-1]),
                descended=bool(chis[-1] < chis[0]),
                peak_bytes=torch.cuda.max_memory_allocated() if device == "cuda" else None)


def row(num_p, num_l, solver, args):
    """run_one's row, or on the card's out-of-memory error a row with the
    error; every other error is raised."""
    if args.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    try:
        return run_one(num_p, num_l, 5.0, solver, args.iters, args.trials, args.device,
                       args.dtype)
    except torch.cuda.OutOfMemoryError as e:
        return dict(P=num_p, L=num_l, solver=solver,
                    error=f"{type(e).__name__}: {str(e).splitlines()[0][:200]}")
    finally:
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()


def crossover(rows):
    """The smallest P where a scalable solver's wall beats the dense one's
    (or the dense one failed), else None."""
    for p in sorted({r["P"] for r in rows}):
        d = next((r for r in rows if r["P"] == p and r["solver"] == "dense_cholesky"), None)
        best = min((r["wall_s"] for r in rows
                    if r["P"] == p and r["solver"] != "dense_cholesky" and "wall_s" in r),
                   default=float("inf"))
        if d is not None and ("error" in d or best < d["wall_s"]):
            return p
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scales", default="2048,4096,8192,16384")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--trials", type=int, default=2)
    ap.add_argument("--lm-per-pose", type=float, default=15.0)
    graphs.add_device_args(ap)
    args = ap.parse_args(argv)
    print(f"device: {graphs.card(args.device)}", flush=True)
    rows = []
    for p in [int(x) for x in args.scales.split(",")]:
        nl = int(p * args.lm_per_pose)
        for solver in SOLVERS:
            r = row(p, nl, solver, args)
            rows.append(r)
            print(json.dumps(r), flush=True)
    print(json.dumps({"summary": "solver_crossover",
                      "first_P_where_scalable_beats_dense": crossover(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
