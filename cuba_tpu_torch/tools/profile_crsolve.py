"""Where cyclic reduction's time goes beyond the factor: the equilibration
and boost decision, one solve sweep, and multi-right-hand-side solves, on
a seeded band of 22 CR blocks.

    python -m cuba_tpu_torch.tools.profile_crsolve [--dtype float32|float64]
        [--device cuda|cpu]

The band is ``np.random.default_rng(0)``'s: D[k] = G G^T / B + 2 I and
U[k] = 0.05 N(0, 1) (U[m-1] = 0), B = ``band_cr.B`` = 384, m = 22 (the
kitti00 graphs' CR block count), and a normal right-hand side.  Stages:
``band_cr.factor`` alone; ``_factor_equilibrated`` (equilibration, the
factor and, in fp32, the boost decision) plus one solve and plus two;
``cr_solve`` at refine 0; the equilibrated factor plus a solve of 96 and
of 384 right-hand sides.  At m = 22 that band is not SPD, so in fp32 the
stages take the boost retry (a second factor) and ``cr_solve`` rejects the
solve; the tool prints which.  The boost decision is a host read
(``band_cr.py``'s one read a factorisation): it costs call ms, not device
ms, so the two columns differ by it.  On the card each stage's call ms
and device ms come from ``roofline.interleaved_kernels`` (25 rounds) with
its three kernels of most device time; without a card it fails (pass
``--device cpu`` for the host, where the times are host times of the plain
versions).
"""

import argparse
import sys

import numpy as np
import torch

from cuba_tpu_torch.solver import band_cr
from cuba_tpu_torch.tools import graphs, roofline

M = 22


def band(m: int, device, dtype):
    """The seeded (D, U, b) with m CR blocks (the numbers of
    ``np.random.default_rng(0)`` in the order the JAX tool draws them, in
    fp32 as it does, then cast to ``dtype``)."""
    B = band_cr.B
    rng = np.random.default_rng(0)
    Dg = rng.normal(size=(m, B, B)).astype(np.float32)
    D = (Dg @ np.swapaxes(Dg, 1, 2) / B + np.eye(B) * 2.0).astype(np.float32)
    U = (rng.normal(size=(m, B, B)) * 0.05).astype(np.float32)
    U[-1] = 0
    b = rng.normal(size=m * B).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device=device, dtype=dtype) for a in (D, U, b))


def solves(D, U, b, count: int):
    """``_factor_equilibrated`` and ``count`` solves through it, each on
    the last one's result (a data dependence, as the JAX tool threads
    one)."""
    solve_with, _reads = band_cr._factor_equilibrated(D, U)
    x = solve_with(b)
    for _ in range(count - 1):
        x = x + solve_with(b + x * 1e-30)
    return x


def multi_rhs(D, U, b, R: int):
    """The equilibrated factor and one solve of R right-hand sides (b
    scaled by 1 + 1e-3 k for column k)."""
    solve_with, _reads = band_cr._factor_equilibrated(D, U)
    scale = 1.0 + torch.arange(R, dtype=b.dtype, device=b.device) * 1e-3
    return solve_with(b[:, None] * scale[None, :])


def stages(D, U, b):
    """{label: fn} of the timed stages."""
    return {
        "factor only": lambda: band_cr.factor(D, U),
        "equilibrate + boost + factor + 1 solve": lambda: solves(D, U, b, 1),
        "cr_solve refine=0": lambda: band_cr.cr_solve(D, U, b, 0),
        "equilibrate + boost + factor + 2 solves": lambda: solves(D, U, b, 2),
        "factor + solve 96 RHS": lambda: multi_rhs(D, U, b, 96),
        "factor + solve 384 RHS": lambda: multi_rhs(D, U, b, 384),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    graphs.add_device_args(ap)
    args = ap.parse_args(argv)
    card = graphs.card(args.device)
    D, U, b = band(M, args.device, getattr(torch, args.dtype))
    times = roofline.stage_times(stages(D, U, b), args.device)
    roofline.print_stages(times, f"CR stages (seeded band, m = {M}, B = {band_cr.B}, "
                                 f"{args.dtype}, {card})")
    _x, ok, reads = band_cr.cr_solve(D, U, b, 0)
    # the seeded band is not SPD at m = 22 (its couplings outweigh the
    # diagonal): the fp32 factor fails, the boost retry factors again and
    # the solve is rejected, the path the stages time, as the JAX tool's did
    print(f"cr_solve refine=0 accepted the seeded band: {bool(ok)}", flush=True)
    base = band_cr.factor(D, U)[1]
    read_ms = roofline.host_read_ms(lambda: bool(~torch.isfinite(base.sum())), args.device)
    one, two = (times[f"equilibrate + boost + factor + {n}"] for n in ("1 solve", "2 solves"))
    sweep = f"{two[0] - one[0]:.4f} call ms" + ("" if one[1] is None else
                                                f", {two[1] - one[1]:.4f} device ms")
    print(f"host reads of one cr_solve: {reads}, the boost decision; one such read (a sum, "
          f"isfinite, the flag to the host) {read_ms:.4f} ms of host clock (median of "
          f"{roofline.READ_REPEATS}; not device time); a second solve sweep adds {sweep}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
