"""The landmark-sharded engine on a one-rank group against the
single-device engine: what the mesh's code costs where there is nothing to
share.

    python -m cuba_tpu_torch.tools.bench_multichip_mxu [--trials 5]
        [--iters 10] [--poses 248] [--landmarks 26127] [--mean-obs 4.65]
        [--dtype float32|float64] [--device cuda|cpu]

On bench.py's kitti07 graph (seed 0, 25% stereo, Huber), fp32 by
default, three engines each run ``optimize(--iters)`` once to warm up and
then ``--trials`` times from their initial state; the least wall (host
clock, ending in a synchronize) counts:

1. the single-device ``BlockSolverEngine``;
2. ``parallel.sharding.MultiChipEngine`` on a one-rank group, on the rows
   route (the single-device engine's plan over the one shard);
3. the same group with ``aos=True``: the AoS body, which the mesh takes
   where a shard does not plan.

It prints each wall and its ratio to the single-device wall, and whether
the rows-route trajectory equals the single-device one bit for bit.  The
group is NCCL on the card and gloo with ``--device cpu``, made and
destroyed by the tool.  On the card by default; without one it fails.
"""

import argparse
import sys
import time

import numpy as np
import torch

from cuba_tpu_torch.config import BAConfig
from cuba_tpu_torch.io import synthetic
from cuba_tpu_torch.parallel.sharding import MultiChipEngine
from cuba_tpu_torch.solver.engine import BlockSolverEngine
from cuba_tpu_torch.tools import graphs


def best_of(engine, iters: int, trials: int):
    """(least wall of ``trials`` optimize(iters) runs after a warm-up, the
    chi² trajectory)."""
    dev = engine.device
    r = engine.optimize(engine.state, iters)
    graphs.sync(dev)
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        r = engine.optimize(engine.state, iters)
        graphs.sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best, np.asarray(r.chis, np.float64)


def run(structure, kernels, config, group, iters: int, trials: int) -> dict:
    """{label: dict(wall, chis, solver, path)} of the three engines."""
    engines = {
        "single-device": lambda: BlockSolverEngine(structure, kernels, config),
        "mesh S=1 rows": lambda: MultiChipEngine(structure, kernels, config, group),
        "mesh S=1 aos": lambda: MultiChipEngine(structure, kernels, config, group, aos=True),
    }
    out = {}
    for label, make in engines.items():
        eng = make()
        wall, chis = best_of(eng, iters, trials)
        out[label] = dict(wall=wall, chis=chis, solver=eng.solver, path=eng.path)
        del eng
    return out


def report(res: dict, iters: int, card: str) -> bool:
    """Print the walls and ratios; True where the rows route's trajectory
    is the single-device one bit for bit."""
    single = res["single-device"]
    for label, r in res.items():
        print(f"{label}: solver {r['solver']}, route {r['path']}, optimize({iters}) "
              f"{r['wall']:.4f} s, ratio to single-device {r['wall'] / single['wall']:.3f}x, "
              f"chi2 {r['chis'][0]:.1f} -> {r['chis'][-1]:.1f} ({card})", flush=True)
    same = np.array_equal(res["mesh S=1 rows"]["chis"], single["chis"])
    print(f"mesh S=1 rows trajectory {'equals' if same else 'differs from'} the "
          f"single-device one bit for bit", flush=True)
    return same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--mean-obs", type=float, default=graphs.KITTI07["mean_obs_per_landmark"])
    graphs.add_size_args(ap)
    graphs.add_device_args(ap)
    args = ap.parse_args(argv)
    params = dict(graphs.graph_params("kitti07", args), mean_obs_per_landmark=args.mean_obs)
    card = graphs.card(args.device)
    prob = synthetic.generate(**params)
    print(f"problem: {params['num_poses']} P / {params['num_landmarks']} L / "
          f"{prob.mono_p.size + prob.stereo_p.size} E, {args.dtype}; {card}", flush=True)
    config = BAConfig(dtype=getattr(torch, args.dtype), device=args.device)
    with graphs.one_rank_group(args.device) as group:
        res = run(graphs.structure_of(prob), graphs.KERNELS, config, group, args.iters,
                  args.trials)
    return 0 if report(res, args.iters, card) else 1


if __name__ == "__main__":
    sys.exit(main())
