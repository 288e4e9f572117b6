"""The band formation and the cyclic-reduction solve of one damped attempt,
stage by stage, on one graph.

    python -m cuba_tpu_torch.tools.profile_formation [--graph kitti00]
        [--reps 20] [--poses P] [--landmarks L] [--dtype float32|float64]
        [--device cuda|cpu]

The graph (``--graph``: ``kitti00``, bench.py's odometry graph, by
default; ``kitti00-loop`` with its loop closure; ``stress``, 1778 P / 1M
L) runs ``solver="band_cr"``.  The first damped attempt's inputs are built
once (``roofline.first_attempt``), and then each stage is timed alone:

- formation: ``segmm.schur_fused``; ``rows.schur_compact`` (fused plus the
  combine); the whole ``rows.schur_band`` (plus ``compact_to_band`` and
  the damped diagonal); and the marginals between them;
- cyclic reduction on that band: ``band_cr.factor`` (no equilibration, no
  boost), ``cr_solve`` at refine 0, 1 and 2, and the factor and refine-1
  solve with the other diagonal-block inverse (``_inv_spd_chol`` beside
  the default ``_inv_spd_rs``).

On the card each stage's call ms (CUDA events, host work included: the
fp32 boost decision is one host read a factorisation) and device ms come
from ``roofline.interleaved_kernels`` over ``--reps`` rounds, with the
stage's three kernels of most device time in the same profiler session.
Then, for the solutions: the relative residual ||A x - b|| / ||b|| (in
fp64) at each refine count and the two inverses' solutions against each
other.  On the card by default; without one it fails (pass ``--device
cpu`` for the host, where the times are host times of the plain versions).
"""

import argparse
import sys

import torch

from cuba_tpu_torch.config import BAConfig
from cuba_tpu_torch.io import synthetic
from cuba_tpu_torch.ops import segmm
from cuba_tpu_torch.solver import band_cr, rows
from cuba_tpu_torch.solver.engine import BlockSolverEngine
from cuba_tpu_torch.tools import graphs, roofline

INVERSES = {"_inv_spd_rs": band_cr._inv_spd_rs, "_inv_spd_chol": band_cr._inv_spd_chol}


def engine_of(params, device, dtype) -> BlockSolverEngine:
    """The graph's engine with ``solver="band_cr"``."""
    s = graphs.structure_of(synthetic.generate(**params))
    return BlockSolverEngine(s, graphs.KERNELS,
                             BAConfig(dtype=dtype, device=device, solver="band_cr"))


def attempt_inputs(engine):
    """The first damped attempt's (HppT, HplT, lam, W, D, U, rhs): its
    band (D, U) and the reduced right-hand side over the padded poses."""
    HppT, HplT, lam, W, bscT = roofline.first_attempt(engine)
    D, U = rows.schur_band(HppT, W, HplT, lam, engine.num_p, engine.plan, engine.rc)
    rhs = bscT.new_zeros(D.shape[0] * band_cr.B)
    rhs[:6 * engine.num_p] = bscT.T.reshape(-1)
    return HppT, HplT, lam, W, D, U, rhs


def formation_stages(engine, HppT, HplT, lam, W):
    """{label: fn} of the formation's stages on the attempt's inputs."""
    plan, rc, P = engine.plan, engine.rc, engine.num_p
    return {
        "schur_fused": lambda: segmm.schur_fused(W, HplT, plan.schur, rc.sc_sb, rc.sc_li,
                                                 rc.sc_lj, rc.sc_lk, csr=rc.csr_sc),
        "schur_compact (fused + combine)": lambda: rows.schur_compact(W, HplT, plan, rc),
        "schur_band (all)": lambda: rows.schur_band(HppT, W, HplT, lam, P, plan, rc),
    }


def cr_stages(D, U, rhs):
    """{label: fn} of the cyclic-reduction stages on the band (D, U)."""
    out = {"cr factor (_inv_spd_rs)": lambda: band_cr.factor(D, U)}
    for r in (0, 1, 2):
        out[f"cr_solve refine={r}"] = lambda r=r: band_cr.cr_solve(D, U, rhs, r)
    chol = band_cr._inv_spd_chol
    out["cr factor (_inv_spd_chol)"] = lambda: band_cr.factor(D, U, chol)
    out["cr_solve refine=1 (_inv_spd_chol)"] = lambda: band_cr.cr_solve(D, U, rhs, 1, inv=chol)
    return out


def residual(D, U, x, rhs) -> float:
    """||A x - b|| / ||b|| of the band (D, U), in fp64."""
    r = band_cr.matvec(D.double(), U.double(), x.double()) - rhs.double()
    return float(r.norm() / rhs.double().norm())


def cr_check(D, U, rhs) -> dict:
    """The solutions' accuracy: ``residual`` {refine: ||Ax - b|| / ||b||}
    with ``_inv_spd_rs``, ``inverses`` the max relative difference of the
    refine-1 solutions with the two inverses (over max |x|), ``ok`` every
    solve accepted and ``reads`` the host reads of one solve."""
    res, xs, oks, reads = {}, {}, [], 0
    for r in (0, 1, 2):
        x, ok, reads = band_cr.cr_solve(D, U, rhs, r)
        res[r] = residual(D, U, x, rhs)
        oks.append(bool(ok))
        if r == 1:
            xs["_inv_spd_rs"] = x
    x, ok, _ = band_cr.cr_solve(D, U, rhs, 1, inv=band_cr._inv_spd_chol)
    xs["_inv_spd_chol"] = x
    oks.append(bool(ok))
    diff = float((xs["_inv_spd_rs"] - x).abs().max() / x.abs().max())
    return dict(residual=res, inverses=diff, ok=all(oks), reads=reads)


def print_marginals(times) -> None:
    """The formation's marginals, in call ms and (on the card) device ms."""
    labels = list(times)[:3]
    for i, what in ((0, "call ms"), (1, "device ms")):
        t = [times[k][i] for k in labels]
        if None in t:
            continue
        print(f"marginals ({what}): combine {t[1] - t[0]:.4f}, compact_to_band and the "
              f"damped diagonal {t[2] - t[1]:.4f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    graphs.add_graph_args(ap, "kitti00")
    graphs.add_device_args(ap)
    args = ap.parse_args(argv)
    params = graphs.graph_params(args.graph, args)
    card = graphs.card(args.device)
    eng = engine_of(params, args.device, getattr(torch, args.dtype))
    if eng.device.type == "cuda":
        segmm.build_kernels()
    HppT, HplT, lam, W, D, U, rhs = attempt_inputs(eng)
    print(f"graph {args.graph}: P {params['num_poses']}, L {params['num_landmarks']}, route "
          f"{eng.path}, CR blocks m = {D.shape[0]}, {args.dtype}; {card}", flush=True)
    fns = dict(formation_stages(eng, HppT, HplT, lam, W), **cr_stages(D, U, rhs))
    times = roofline.stage_times(fns, eng.device, args.reps)
    roofline.print_stages(times, f"formation and CR stages ({args.graph}, m = {D.shape[0]}, "
                                 f"{args.dtype}, {card})")
    print_marginals(times)
    chk = cr_check(D, U, rhs)
    print("CR solutions: ||Ax - b|| / ||b|| " + ", ".join(
        f"refine {r} {v:.3e}" for r, v in chk["residual"].items())
        + f"; _inv_spd_rs vs _inv_spd_chol (refine 1) max rel diff {chk['inverses']:.3e}; "
        f"host reads a solve {chk['reads']}", flush=True)
    return 0 if chk["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
