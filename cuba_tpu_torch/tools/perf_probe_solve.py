"""The dense reduced solve's stages and accuracy at the kitti00 loop
graph's dense size: the Cholesky factor, the whole ``cholesky_solve`` at
refine 0, 1 and 2, and each solution's error against a fp64 NumPy solve.

    python -m cuba_tpu_torch.tools.perf_probe_solve [--n 8448] [--reps 20]
        [--dtype float32|float64] [--device cuda|cpu]

The system is SPD with a BA-like conditioning after equilibration: A = G
G^T / n + 1e-2 I from a seeded normal G (``np.random.default_rng(0)``),
Jacobi-scaled to a unit diagonal plus 0.2 I, and a seeded normal b.
``dense_cholesky.factor`` (``cholesky_ex`` with the fp32 boost retry) and
``dense_cholesky.cholesky_solve`` with the blocked sweeps of
``solver/trisolve.py`` where they take the size (``trisolve.usable``;
their kernels on the card) are timed by ``roofline.interleaved_kernels``
over ``--reps`` rounds: call ms (CUDA events, host work included: the boost
decision is a host read) and device ms, with each stage's three kernels of
most device time.  The two sweeps and the refinement matvec alone, beside
their torch calls, are ``tools/probe_trisolve.py``'s measurement, which
this tool does not repeat.  Then the relative error ||x - x64|| / ||x64||
of each refine count, x64 from ``np.linalg.solve`` in fp64 on the host.
On the card by default; without one it fails (pass ``--device cpu`` for
the host, where the times are host times of the plain versions).
"""

import argparse
import sys

import numpy as np
import torch

from cuba_tpu_torch.solver import dense_cholesky, trisolve
from cuba_tpu_torch.tools import graphs, roofline

REFINES = (0, 1, 2)


def system(n: int, device, dtype):
    """The seeded (A, b): G and b drawn in fp32 on the host, A formed and
    equilibrated in ``dtype`` on ``device``."""
    rng = np.random.default_rng(0)
    G = torch.from_numpy(rng.normal(size=(n, n)).astype(np.float32)).to(device=device,
                                                                         dtype=dtype)
    b = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(device=device, dtype=dtype)
    A = G @ G.T / n
    del G
    A.diagonal().add_(1e-2)
    d = torch.rsqrt(torch.diagonal(A))
    A = A * d[:, None] * d[None, :]
    A.diagonal().add_(0.2)
    return A, b


def solve(A, b, refine: int):
    """``cholesky_solve`` as the engine runs it on this size: (x, ok)."""
    x, ok, _reads = dense_cholesky.cholesky_solve(
        A, b, refine, use_kernels=trisolve.usable(A.shape[0], A.dtype))
    return x, ok


def stages(A, b):
    """{label: fn} of the timed stages."""
    s = torch.rsqrt(torch.diagonal(A))
    As = A * s[:, None] * s[None, :]
    out = {"factor (cholesky_ex, boost decision)": lambda: dense_cholesky.factor(As)}
    for r in REFINES:
        out[f"cholesky_solve refine={r}"] = lambda r=r: solve(A, b, r)
    return out


def accuracy(A, b) -> dict:
    """{refine: ||x - x64|| / ||x64||}, x64 the fp64 NumPy solve; raises
    where a solve is rejected."""
    A64 = A.double().cpu().numpy()
    x64 = np.linalg.solve(A64, b.double().cpu().numpy())
    out = {}
    for r in REFINES:
        x, ok = solve(A, b, r)
        if not bool(ok):
            raise RuntimeError(f"cholesky_solve refine={r} rejected the system")
        out[r] = float(np.linalg.norm(x.double().cpu().numpy() - x64) / np.linalg.norm(x64))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=8448)
    ap.add_argument("--reps", type=int, default=20)
    graphs.add_device_args(ap)
    args = ap.parse_args(argv)
    card = graphs.card(args.device)
    dtype = getattr(torch, args.dtype)
    A, b = system(args.n, args.device, dtype)
    blocked = trisolve.usable(args.n, dtype)
    print(f"n {args.n}, {args.dtype}, sweeps: {'blocked (trisolve)' if blocked else 'torch'}; "
          f"{card}", flush=True)
    times = roofline.stage_times(stages(A, b), args.device, args.reps)
    roofline.print_stages(times, f"dense solve stages (n = {args.n}, {args.dtype}, {card})")
    print("the sweep pair and the refinement matvec alone: python3 "
          "cuba_tpu_torch/tools/probe_trisolve.py --sizes N", flush=True)
    for r, err in accuracy(A, b).items():
        print(f"solve rel err refine={r}: {err:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
