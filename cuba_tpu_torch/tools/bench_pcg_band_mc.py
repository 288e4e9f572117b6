"""The sharded-PCG against replicated-band model of a landmark-sharded
solve over S devices, from what one device measures.

    python -m cuba_tpu_torch.tools.bench_pcg_band_mc [--reps 20]
        [--loop-closures | --no-loop-closures] [--pcg-tol TOL]
        [--poses P] [--landmarks L] [--dtype float32|float64]
        [--device cuda|cpu]

On bench.py's kitti00 graph (with its loop closure by default), solver
``band_cr``, on the first attempt's inputs damped at the JAX tool's fixed
λ = ``roofline.LAM0`` = 1e-3 (``roofline.first_attempt``; W, the band, the
right-hand side and PCG alike), it times:

  t_form  ``rows.schur_compact``: the compact Schur table, which a mesh
          sums over its shards (shardable)
  t_band  ``rows.band_from_compact`` + ``band_cr.cr_solve`` at refine 1,
          replicated on every device: the whole band solve less t_form
  t_pcg   ``rows.pcg_solve_rows`` to ``--pcg-tol`` (default
          ``BAConfig.pcg_tol``) or ``BAConfig.pcg_max_iterations`` steps,
          with its step count n_cg and whether it converged

and t_lat, the part of one CG step a mesh cannot shard, measured here: the
median host-clock time of the stop test's host read plus a one-rank
``all_reduce`` of the [6, P] pose vector (NCCL on the card, gloo on the
host).  One card gives no NVLink latency between cards, so t_lat is a
lower bound.  The model, per damped attempt:

  band(S) = t_form / S + t_band
  pcg(S)  = (t_pcg - n_cg t_lat) / S + n_cg t_lat

printed for S = 1 ... 128 with the smallest S where PCG wins, where
``cr_solve`` accepts the band (where it rejects it, t_band times a
rejected solve, and no crossover is reported).  The times
are call ms (CUDA events, host work included: PCG reads the host once a
step), as t_lat is; the device ms are printed beside them.  A model, not a
measurement of a mesh.  On the card by default; without one it fails (pass
``--device cpu`` for the host, where the times are host times of the plain
versions).
"""

import argparse
import sys

import torch

from cuba_tpu_torch.ops import segmm
from cuba_tpu_torch.solver import band_cr, rows
from cuba_tpu_torch.tools import graphs, roofline
from cuba_tpu_torch.tools.profile_formation import engine_of

MESH_SIZES = (1, 2, 4, 8, 16, 32, 64, 128)


def pcg(engine, HppT, HplT, W, lam, tol):
    """``pcg_solve_rows`` on the attempt's inputs (bT = the undamped bp
    rows, as the JAX tool solves): (xT, ok, n_cg)."""
    cfg = engine.config
    return rows.pcg_solve_rows(HppT, HplT, W, lam, HppT[36:42], engine.num_p, engine.num_l,
                               engine.plan, engine.rc, cfg.pcg_max_iterations, tol)


def attempt_of(engine):
    """The first attempt's (HppT, HplT, lam, W, bscT) at λ = LAM0."""
    return roofline.first_attempt(engine, roofline.LAM0)


def stages(engine, attempt, tol):
    """{label: fn} of the three timed solves."""
    HppT, HplT, lam, W, bscT = attempt
    plan, rc, P = engine.plan, engine.rc, engine.num_p
    rhs = bscT.new_zeros(6 * plan.pad_blocks)
    rhs[:6 * P] = bscT.T.reshape(-1)

    def band():
        gT = rows.schur_compact(W, HplT, plan, rc)
        D, U = rows.band_from_compact(gT, HppT, lam, P, plan, rc)
        return band_cr.cr_solve(D, U, rhs, 1)

    return {"t_form": lambda: rows.schur_compact(W, HplT, plan, rc),
            "band + CR (form incl.)": band,
            "t_pcg": lambda: pcg(engine, HppT, HplT, W, lam, tol)}


def t_lat_ms(engine, group) -> float:
    """The replicated part of one CG step: the stop test's host read and
    the [6, P] all-reduce, median host-clock ms (``roofline.host_read_ms``)."""
    import torch.distributed as dist

    v = torch.ones((6, engine.num_p), dtype=engine.dtype, device=engine.device)
    tol2 = torch.tensor(1e-20, dtype=engine.dtype, device=engine.device)

    def step():
        out = v.clone()
        dist.all_reduce(out, group=group)
        return bool((out * out).sum() > tol2)

    return roofline.host_read_ms(step, engine.device)


def model(t_form, t_band, t_pcg, n_cg, t_lat):
    """[(S, band ms, pcg ms)] for MESH_SIZES, and the smallest S where PCG
    is faster (None if none)."""
    rep = n_cg * t_lat
    table = [(S, t_form / S + t_band, (t_pcg - rep) / S + rep) for S in MESH_SIZES]
    return table, next((S for S, b, p in table if p < b), None)


def measure(engine, reps: int, tol: float, card: str) -> dict:
    """Time the three solves on the engine's first attempt at λ = LAM0, count
    PCG's steps, measure t_lat over a one-rank group and print the model
    (call ms); no crossover where CR rejects the band it times.  Returns
    the numbers: ``times`` ({label: (call ms, device ms, top kernels)}),
    ``lam``, ``band_ok``, ``n_cg``, ``converged``, ``t_lat``, ``crossover``."""
    attempt = attempt_of(engine)
    fns = stages(engine, attempt, tol)
    times = roofline.stage_times(fns, engine.device, reps)
    roofline.print_stages(times, f"solve stages (P {engine.num_p}, {engine.dtype}, {card})")
    band_ok = bool(fns["band + CR (form incl.)"]()[1])
    print(f"band solve accepted={band_ok} (lambda {float(attempt[2]):g})", flush=True)
    _x, ok, n_cg = pcg(engine, attempt[0], attempt[1], attempt[3], attempt[2], tol)
    print(f"pcg converged={bool(ok)} n_cg={n_cg} (cap {engine.config.pcg_max_iterations}, tol "
          f"{tol:g}, lambda {float(attempt[2]):g})", flush=True)
    with graphs.one_rank_group(engine.device) as group:
        t_lat = t_lat_ms(engine, group)
    print(f"t_lat {t_lat:.4f} ms: the stop test's host read + a one-rank all_reduce of [6, "
          f"{engine.num_p}], median of {roofline.READ_REPEATS} (a lower bound: NVLink latency "
          f"between cards is not measured, one card)", flush=True)
    # call ms: t_lat is host clock, and PCG's host reads are not device time
    t = {k: v[0] for k, v in times.items()}
    t_band = max(t["band + CR (form incl.)"] - t["t_form"], 1e-6)
    table, cross = model(t["t_form"], t_band, t["t_pcg"], n_cg, t_lat)
    print(f"\nmodel (call ms; a model, not a mesh measurement): band(S) = {t['t_form']:.4f}/S "
          f"+ {t_band:.4f} ms; pcg(S) = {t['t_pcg'] - n_cg * t_lat:.4f}/S + "
          f"{n_cg * t_lat:.4f} ms (t_lat {t_lat:.4f} ms a step)\n\n"
          "| S | band ms | pcg ms | winner |\n|---|---|---|---|", flush=True)
    for S, b, p in table:
        print(f"| {S} | {b:.4f} | {p:.4f} | {'band' if b <= p else 'pcg'} |", flush=True)
    if band_ok:
        print(f"crossover: sharded PCG beats the replicated band solve from S = "
              f"{cross if cross else '>128'}", flush=True)
    else:
        cross = None
        print("crossover: none reported: CR rejects the band at this lambda, so t_band times "
              "a rejected solve", flush=True)
    return dict(times=times, lam=float(attempt[2]), band_ok=band_ok, n_cg=n_cg,
                converged=bool(ok), t_lat=t_lat, crossover=cross)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--loop-closures", action="store_true", default=True)
    ap.add_argument("--no-loop-closures", dest="loop_closures", action="store_false")
    ap.add_argument("--pcg-tol", type=float, default=None)
    graphs.add_size_args(ap)
    graphs.add_device_args(ap)
    args = ap.parse_args(argv)
    graph = "kitti00-loop" if args.loop_closures else "kitti00"
    params = graphs.graph_params(graph, args)
    card = graphs.card(args.device)
    eng = engine_of(params, args.device, getattr(torch, args.dtype))
    if eng.device.type == "cuda":
        segmm.build_kernels()
    print(f"graph {graph}: P {params['num_poses']}, L {params['num_landmarks']}, route "
          f"{eng.path}, CR blocks m = {eng.band_m}, {args.dtype}; {card}", flush=True)
    measure(eng, args.reps, eng.config.pcg_tol if args.pcg_tol is None else args.pcg_tol,
            card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
