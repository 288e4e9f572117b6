"""Run bundle adjustment on a graph JSON file and print the time profile.

The port of ``samples/sample_ba_from_file.py`` (reference:
samples/sample_ba_from_file.cpp:31-75): loads the cv::FileStorage-JSON graph,
does a warm-up initialize + optimize (the kernels' first build and launch),
then runs a timed initialize + optimize(10) and prints the per-phase profile
and the per-iteration chi2.

Usage:  python -m cuba_tpu_torch.samples.sample_ba_from_file <graph.json> [--iters 10]
        python -m cuba_tpu_torch.samples.sample_ba_from_file --synthetic [--poses N --landmarks M]

On the card unless given ``--cpu``; ``--fp64`` runs in float64 on either
(on the card through the fp64 builds of the CUDA kernels).
"""

import argparse
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("graph", nargs="?", help="graph JSON (reference format)")
    ap.add_argument("--synthetic", action="store_true", help="use a synthetic problem")
    ap.add_argument("--poses", type=int, default=100)
    ap.add_argument("--landmarks", type=int, default=2000)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument(
        "--profiled",
        action="store_true",
        help="host-stepped driver with exact per-phase timing (slower); "
        "default is the plain loop with its phases split by their marks",
    )
    ap.add_argument("--fp64", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)

    from cuba_tpu_torch import BAConfig, EdgeType, RobustKernelType
    from cuba_tpu_torch.io import json_io, synthetic

    config = BAConfig(dtype=torch.float64 if args.fp64 else torch.float32,
                      device="cpu" if args.cpu else "cuda")

    def load():
        if args.synthetic or not args.graph:
            prob = synthetic.generate(num_poses=args.poses, num_landmarks=args.landmarks, seed=0)
            ba = synthetic.build_graph(prob, config)
        else:
            ba = json_io.read_graph(args.graph, config)
        ba.set_robust_kernels(RobustKernelType.HUBER, float(np.sqrt(5.991)), EdgeType.MONOCULAR)
        ba.set_robust_kernels(RobustKernelType.HUBER, float(np.sqrt(7.815)), EdgeType.STEREO)
        return ba

    ba = load()
    print(f"num poses      : {ba.nposes()}")
    print(f"num landmarks  : {ba.nlandmarks()}")
    print(f"num edges      : {ba.nedges()}")

    # warm-up (excluded from timing, like the reference sample)
    ba.initialize()
    ba.optimize(1 if args.profiled else args.iters)

    ba = load()
    t0 = time.perf_counter()
    ba.initialize()
    ba.optimize(args.iters, profile=args.profiled)
    elapsed = time.perf_counter() - t0

    print("=== Time profile ===")
    prof = ba.time_profile()
    attributed = ba.attributed_phases()
    for k, v in prof.items():
        mark = " *" if k in attributed else ""
        print(f"{k:32s}: {1e3 * v:9.1f} ms{mark}")
    print(f"{'Total':32s}: {1e3 * elapsed:9.1f} ms")
    if attributed:
        print(
            "* attributed: these rows split the measured optimize wall by the "
            "loop's phase marks (CUDA events on the card, the host clock on "
            "the CPU); run with --profiled for host-timed exact phases"
        )
    print("=== Objective ===")
    for s in ba.batch_statistics():
        print(f"iter {s.iteration:2d}: chi2 = {s.chi2:.1f}")


if __name__ == "__main__":
    main()
