"""Multi-device bundle adjustment through the public API.

The port of ``samples/sample_multichip.py``: the same ``BundleAdjustment``
surface, with ``BAConfig(mesh=group)``, runs landmark-sharded over a
``torch.distributed`` process group, one process a rank
(``cuba_tpu_torch/parallel/``).  ``--devices N`` spawns N ranks: on the
host over gloo; on the card one rank over NCCL, N ranks on one card over
gloo, N cards (where present) over NCCL.  Each rank builds the same
seeded graph; the sample prints every rank's trajectory and the final
chi², and exits non-zero if the ranks disagree.

Usage:  python -m cuba_tpu_torch.samples.sample_multichip [--devices N]
        [--poses P] [--landmarks L] [--iters K] [--solver auto|pcg|...]
        [--device cuda|cpu]
"""

import argparse
import sys

import numpy as np

TIMEOUT = 600.0  # seconds before every rank is killed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=4, help="ranks (landmark shards)")
    ap.add_argument("--poses", type=int, default=60)
    ap.add_argument("--landmarks", type=int, default=1200)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--solver", default="auto",
                    choices=["auto", "dense_cholesky", "band_cr", "band_lr", "pcg"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import torch

    from cuba_tpu_torch.io import synthetic
    from cuba_tpu_torch.parallel import drive, launch

    n = args.devices
    backend = "gloo"
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu to run on the host")
        from cuba_tpu_torch.ops import cudalib

        cudalib.build_kernels()  # once, before the ranks load the libraries
        if n == 1 or torch.cuda.device_count() >= n:
            backend = "nccl"
    where = ("the host" if args.device == "cpu" else
             f"{min(n, torch.cuda.device_count())} card(s)")
    print(f"mesh: {n} rank(s) on {where} over {backend}, axis 'landmarks'")

    prob = synthetic.generate(num_poses=args.poses, num_landmarks=args.landmarks, seed=1)
    case = dict(name="run", kind="api", problem=prob, iters=args.iters,
                config=dict(solver=args.solver))
    res = launch.spawn(drive.run_cases, n, backend=backend, device=args.device,
                       timeout=TIMEOUT, args=([case],))
    for rank, r in enumerate(res):
        print(f"rank {rank}: solver {r['run.solver']}, route {r['run.path']}, "
              f"optimize({args.iters}) {float(r['run.wall']):.3f} s, chi2 "
              + " ".join(f"{c:.2f}" for c in r["run.chis"]))
    agree = all(np.array_equal(r[f"run.{k}"], res[0][f"run.{k}"])
                for r in res for k in ("chis", "pose_t", "pose_q", "lm_Xw"))
    print(f"final chi2 {res[0]['run.chis'][-1]:.4f}; ranks agree bit for bit: {agree}")
    if not agree:
        sys.exit("the ranks disagree")


if __name__ == "__main__":
    main()
