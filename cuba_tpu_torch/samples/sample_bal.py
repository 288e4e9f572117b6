"""Run bundle adjustment on a BAL-format problem file.

The port of ``samples/sample_bal.py``: loads any problem from the public
"Bundle Adjustment in the Large" collection (grail.cs.washington.edu/projects/bal
— e.g. problem-49-7776-pre.txt.bz2 decompressed to .txt, or gzipped),
converts it to the +z pinhole model (see ``cuba_tpu_torch/io/bal.py``),
optimizes, and prints the per-iteration chi2 and reprojection RMSE.

Usage:  python -m cuba_tpu_torch.samples.sample_bal data/bal_toy.txt.gz [--iters 10]

On the card unless given ``--cpu``.
"""

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("problem", nargs="?", default="data/bal_toy.txt.gz")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--huber", type=float, default=0.0, help="Huber delta (0 = off)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)

    from cuba_tpu_torch import BAConfig, EdgeType, RobustKernelType
    from cuba_tpu_torch.io import bal

    config = BAConfig(device="cpu" if args.cpu else "cuda")

    def load():
        ba = bal.read_bal(args.problem, config)
        if args.huber > 0:
            ba.set_robust_kernels(RobustKernelType.HUBER, args.huber, EdgeType.MONOCULAR)
        return ba

    ba = load()
    print(f"problem        : {args.problem}")
    print(f"num cameras    : {ba.nposes()}")
    print(f"num points     : {ba.nlandmarks()}")
    print(f"num obs        : {ba.nedges()}")

    # warm-up (the kernels' first build and launch, excluded from timing)
    ba.initialize()
    ba.optimize(args.iters)

    ba = load()
    t0 = time.perf_counter()
    ba.initialize()
    ba.optimize(args.iters)
    elapsed = time.perf_counter() - t0

    stats = ba.batch_statistics()
    for s in stats:
        print(f"iter {s.iteration:2d}: chi2 = {s.chi2:.3f}")
    n = ba.nedges()
    rmse0 = np.sqrt(stats[0].chi2 / n)
    rmse1 = np.sqrt(stats[-1].chi2 / n)
    print(f"reprojection RMSE: {rmse0:.4f} px -> {rmse1:.4f} px")
    print(f"wall time ({len(stats)} iters): {elapsed:.3f} s")


if __name__ == "__main__":
    main()
