"""The single-device engine against an 8-rank landmark-sharded mesh in
fp64, on bench.py's kitti07 graph, over 5 LM iterations.

    python -m cuba_tpu_torch.tools.mc_parity [--poses 248] [--landmarks 26127]
        [--dtype float64|float32] [--device cuda|cpu]

fp64, because the shards' sums and their all-reduce add in another order
than one device does: ~1e-15 a sum in fp64, where fp32's ~1e-7 grows
through the LM trajectory.  The single-device ``BlockSolverEngine`` runs
in this process; the eight ranks are spawned by
``parallel.launch.spawn`` (gloo; on the card every rank on card 0, each
with its own CUDA context; every rank is killed if one fails or the time
limit passes) and run ``MultiChipEngine`` through
``parallel.drive.run_cases``.  It prints both walls (the mesh's per rank,
eight processes sharing one card: not a speed figure) and the maximum
relative chi² difference per iteration, and exits 1 unless it is under
1e-6.  On the card by default; without one it fails (pass ``--device
cpu`` for the host).
"""

import argparse
import sys
import time

import numpy as np
import torch

from cuba_tpu_torch.config import BAConfig
from cuba_tpu_torch.io import synthetic
from cuba_tpu_torch.parallel import drive, launch
from cuba_tpu_torch.solver.engine import BlockSolverEngine
from cuba_tpu_torch.tools import graphs

RANKS = 8
ITERS = 5
RTOL = 1e-6
TIMEOUT = 300.0  # seconds before every rank is killed


def single(structure, dtype, device):
    """(chi² trajectory, wall s) of the single-device engine's
    optimize(ITERS), construction included."""
    t0 = time.perf_counter()
    eng = BlockSolverEngine(structure, graphs.KERNELS, BAConfig(dtype=dtype, device=device))
    r = eng.optimize(eng.state, ITERS)
    graphs.sync(device)
    return np.asarray(r.chis, np.float64), time.perf_counter() - t0


def mesh(structure, dtype, device, ranks: int = RANKS, timeout: float = TIMEOUT):
    """Every rank's results of the same run over ``ranks`` spawned gloo
    ranks (``drive``'s engine case "mc": chis, wall, init_wall, ...)."""
    case = dict(name="mc", kind="engine", structure=structure, kernels=graphs.KERNELS,
                config=dict(dtype=dtype), iters=ITERS)
    return launch.spawn(drive.run_cases, ranks, "gloo", device, timeout, args=([case],))


def max_rel(chis, ref) -> float:
    """The largest relative difference of two trajectories, infinite where
    their lengths differ."""
    if len(chis) != len(ref):
        return float("inf")
    return float(np.max(np.abs(chis - ref) / np.abs(ref)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    graphs.add_size_args(ap)
    graphs.add_device_args(ap, dtype="float64")
    args = ap.parse_args(argv)
    params = graphs.graph_params("kitti07", args)
    card = graphs.card(args.device)
    dtype = getattr(torch, args.dtype)
    prob = synthetic.generate(**params)
    s = graphs.structure_of(prob)
    print(f"problem: {params['num_poses']} P / {params['num_landmarks']} L / "
          f"{prob.mono_p.size + prob.stereo_p.size} E, {args.dtype}; {card}", flush=True)
    chis1, wall1 = single(s, dtype, args.device)
    print(f"single device: optimize({ITERS}) with construction {wall1:.2f} s, chis "
          f"{chis1.tolist()}", flush=True)
    t0 = time.perf_counter()
    res = mesh(s, dtype, args.device)
    walls = [float(r["mc.wall"]) for r in res]
    print(f"{RANKS}-rank mesh (gloo, spawned): {time.perf_counter() - t0:.2f} s in all, "
          f"optimize({ITERS}) per rank {min(walls):.2f}-{max(walls):.2f} s, route "
          f"{res[0]['mc.path']}, solver {res[0]['mc.solver']}, chis "
          f"{res[0]['mc.chis'].tolist()}", flush=True)
    same = all(np.array_equal(r["mc.chis"], res[0]["mc.chis"]) for r in res)
    rel = max_rel(res[0]["mc.chis"], chis1)
    ok = same and rel < RTOL
    print(f"parity max rel: {rel:.2e}; every rank the same trajectory: {same} -> "
          f"{'OK' if ok else 'FAIL'} (< {RTOL:g})", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
