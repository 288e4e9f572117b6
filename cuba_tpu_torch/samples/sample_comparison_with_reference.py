"""Compare the port against the independent NumPy/SciPy reference solver on
the same graph — the port of ``samples/sample_comparison_with_reference.py``,
the analogue of the reference's g2o comparison (reference:
samples/sample_comparison_with_g2o.cpp:43-308): identical graph into both
optimizers, per-iteration chi2 side by side, and RMSE between the final
rotation/translation/landmark estimates.

Usage:  python -m cuba_tpu_torch.samples.sample_comparison_with_reference [graph.json]

On the card the port runs fp32 against the fp64 oracle; with ``--cpu`` it
runs fp64.
"""

import argparse

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("graph", nargs="?", help="graph JSON (reference format)")
    ap.add_argument("--poses", type=int, default=20)
    ap.add_argument("--landmarks", type=int, default=300)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--cpu", action="store_true", help="run fp64 on the CPU, not the card")
    args = ap.parse_args(argv)

    from cuba_tpu_torch import BAConfig, EdgeType, RobustKernelType
    from cuba_tpu_torch.io import json_io, synthetic
    from cuba_tpu_torch.reference.solver import RefProblem, ReferenceSolver

    config = (BAConfig(dtype=torch.float64, device="cpu") if args.cpu
              else BAConfig(dtype=torch.float32, device="cuda"))
    if args.graph:
        ba = json_io.read_graph(args.graph, config)
    else:
        prob = synthetic.generate(num_poses=args.poses, num_landmarks=args.landmarks, seed=0)
        ba = synthetic.build_graph(prob, config)
    ba.set_robust_kernels(RobustKernelType.HUBER, float(np.sqrt(5.991)), EdgeType.MONOCULAR)
    ba.set_robust_kernels(RobustKernelType.HUBER, float(np.sqrt(7.815)), EdgeType.STEREO)

    ba.initialize()
    ref = ReferenceSolver(RefProblem.from_structure(ba._engine.structure, ba._kernels))

    ba.optimize(args.iters)
    chis_port = [s.chi2 for s in ba.batch_statistics()]
    chis_ref = ref.optimize(args.iters)

    dtype = str(config.dtype).replace("torch.", "")
    print(f"{'iter':>4} | {'chi2 (port ' + dtype + ')':>18} | {'chi2 (numpy ref)':>18} | "
          f"{'rel diff':>10}")
    for i in range(min(len(chis_port), len(chis_ref))):
        rel = abs(chis_port[i] - chis_ref[i]) / abs(chis_ref[i])
        print(f"{i:4d} | {chis_port[i]:18.4f} | {chis_ref[i]:18.4f} | {rel:10.2e}")

    s = ba._engine.structure
    qs = ba._state.qs.double().cpu().numpy()[: s.num_p]
    ts = ba._state.ts.double().cpu().numpy()[: s.num_p]
    Xws = ba._state.Xws.double().cpu().numpy()[: s.num_l]
    print("=== estimate RMSE (port vs reference) ===")
    print(f"rotation   : {np.sqrt(np.mean((qs - ref.p.qs[:s.num_p]) ** 2)):.3e}")
    print(f"translation: {np.sqrt(np.mean((ts - ref.p.ts[:s.num_p]) ** 2)):.3e}")
    print(f"landmark   : {np.sqrt(np.mean((Xws - ref.p.Xws[:s.num_l]) ** 2)):.3e}")


if __name__ == "__main__":
    main()
