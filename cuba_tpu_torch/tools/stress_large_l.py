"""The large-landmark regime on one device: by default 1778 poses, 1,000,000
landmarks, ~5 observations each (3,885,457 edges, 25% stereo, seed 0), the
scale of the BAL/Venice problems, where everything that grows with L and E
(the per-edge rows, the Hpl slot tables, the triplet stream of
``schur_fused``) is stressed.

    python -m cuba_tpu_torch.tools.stress_large_l [--landmarks 1000000]
        [--poses 1778] [--mean-obs 5.0] [--solver auto] [--iters 10]
        [--dtype float32|float64] [--device cuda|cpu]

It builds the structure from the generator's arrays and the engine
(``BlockSolverEngine``) on the device, and prints the host seconds of each
step (``generate``, ``structure`` with the Hpl slots, Schur blocks and
triplets, ``ctor`` with the route, solver, CR blocks and the plan's
paddings, chunks and kwin), the memory plan (the bytes of the dominant
device tensors, read from the engine's own tensors after one damped
attempt's steps: the row tables, the edge rows, W and HplT, the
``schur_fused`` output, the compact table gT and the band or dense
storage), then a cold and a warm ``optimize(iters)``, each ending in a
synchronize, the chi² from first to last and the device's peak memory
(``torch.cuda.max_memory_allocated``) of the optimize.  The last line is
one ``stress`` JSON object.  It exits non-zero unless the trajectory is
finite and falls.  On the card by default; without one it fails (pass
``--device cpu`` for the host).
"""

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from cuba_tpu_torch.config import BAConfig
from cuba_tpu_torch.io import synthetic
from cuba_tpu_torch.solver import rows
from cuba_tpu_torch.solver.engine import BlockSolverEngine
from cuba_tpu_torch.tools import graphs


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--landmarks", type=int, default=graphs.STRESS["num_landmarks"])
    ap.add_argument("--poses", type=int, default=graphs.STRESS["num_poses"])
    ap.add_argument("--mean-obs", type=float, default=graphs.STRESS["mean_obs_per_landmark"])
    ap.add_argument("--solver", default="auto")
    ap.add_argument("--iters", type=int, default=10)
    graphs.add_device_args(ap)
    return ap.parse_args(argv)


def problem(args):
    return synthetic.generate(
        num_poses=args.poses, num_landmarks=args.landmarks,
        mean_obs_per_landmark=args.mean_obs, stereo_fraction=graphs.STRESS["stereo_fraction"],
        seed=graphs.STRESS["seed"])


def engine_of(structure, args) -> BlockSolverEngine:
    config = BAConfig(dtype=getattr(torch, args.dtype), solver=args.solver, device=args.device)
    return BlockSolverEngine(structure, graphs.KERNELS, config)


def plan_facts(engine) -> dict:
    """The route and the plan's sizes: route, solver, CR blocks, Wg, the
    edge and slot paddings, schur_fused's chunks and kwin, PB."""
    plan = engine.plan
    facts = dict(route=engine.path, solver=engine.solver, band_m=engine.band_m,
                 pad_blocks=engine.pad_blocks)
    if plan is not None:
        facts.update(wg=plan.wg, e_pad_m=plan.e_pad_m, e_pad_s=plan.e_pad_s,
                     hpl_pad=plan.hpl_pad)
        if plan.schur is not None:
            facts.update(schur_chunks=plan.schur.num_chunks, kwin=plan.schur.kwin)
    return facts


def _nbytes(x) -> int:
    """The bytes of the tensors in ``x`` (a tensor, a tuple or a dataclass
    or named tuple of them)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if dataclasses.is_dataclass(x):
        return sum(_nbytes(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(v) for v in x)
    return 0


def _shape(t: torch.Tensor) -> str:
    return f"[{', '.join(str(n) for n in t.shape)}] {str(t.dtype).removeprefix('torch.')}"


def memory_plan(engine):
    """[(name, bytes)] of the engine's dominant device tensors: its row
    tables, and the tensors of one damped attempt on its initial state as
    its steps make them (the edge rows, HplT, W, the schur_fused output,
    the compact table and the band or dense storage).  The attempt's
    tensors are freed on return."""
    from cuba_tpu_torch.ops import segmm

    plan, rc, st = engine.plan, engine.rc, engine.state
    out = [("state + cameras", _nbytes(tuple(st)) + _nbytes(engine.cams))]
    if plan is None:
        return out
    out.append(("row tables (RowConsts, with the CSRs)", _nbytes(rc)))
    pack_m, pack_s, _chi = engine._residuals_and_chi(st)
    for label, pack in (("mono", pack_m), ("stereo", pack_s)):
        if pack is not None:
            out.append((f"edge rows, {label} (g12 {_shape(pack[0])}, err, Xc, inv_z)",
                        _nbytes(pack)))
    HppT, HllT, HplT = engine._build(pack_m, pack_s)
    del pack_m, pack_s
    out.append((f"HplT {_shape(HplT)}", _nbytes(HplT)))
    out.append((f"HllT {_shape(HllT)} + HppT {_shape(HppT)}", _nbytes((HllT, HppT))))
    lam = engine.config.tau * rows.max_diagonal_T(HppT, HllT)
    iv9, W, bscT, g12 = rows.prepare_factors(HppT, HllT, HplT, lam, engine.num_p, rc)
    W = W.contiguous()
    out.append((f"W {_shape(W)}", _nbytes(W)))
    out.append((f"landmark factors iv9 {_shape(iv9)} + g12", _nbytes((iv9, g12))))
    if plan.schur is not None:
        sc = (plan.schur, rc.sc_sb, rc.sc_li, rc.sc_lj, rc.sc_lk)
        win = segmm.schur_fused(W, HplT, *sc, csr=rc.csr_sc)
        out.append((f"schur_fused output {_shape(win)}", _nbytes(win)))
        del win
        if plan.v2:
            gT = rows.schur_compact(W, HplT, plan, rc)
            out.append((f"compact table gT {_shape(gT)}", _nbytes(gT)))
            if engine.solver in ("band_cr", "band_lr"):
                D, U = rows.band_from_compact(gT, HppT, lam, engine.num_p, plan, rc)
                out.append((f"band storage D {_shape(D)} + U", _nbytes((D, U))))
            elif engine.solver == "dense_cholesky":
                A = rows.dense_from_compact(gT, HppT, lam, engine.num_p, plan, rc)
                out.append((f"dense Schur matrix {_shape(A)}", _nbytes(A)))
    graphs.sync(engine.device)
    return out


def _fmt_bytes(b: int) -> str:
    return f"{b / 1e9:.3f} GB" if b >= 1e8 else f"{b / 1e6:.1f} MB"


def main(argv=None) -> int:
    args = parse(argv)
    cuda = args.device == "cuda"
    print(f"device: {graphs.card(args.device)}", flush=True)
    t0 = time.perf_counter()
    prob = problem(args)
    nE = prob.mono_p.size + prob.stereo_p.size
    print(f"generate: {time.perf_counter() - t0:.2f} s  {args.poses} P / {args.landmarks} L / "
          f"{nE} E ({prob.stereo_p.size} stereo)", flush=True)
    t0 = time.perf_counter()
    s = graphs.structure_of(prob)
    del prob
    t_struct = time.perf_counter() - t0
    print(f"structure: {t_struct:.2f} s  n_hpl={s.n_hpl} n_hsc={s.n_hsc} "
          f"triplets={s.mul_i.size}", flush=True)
    t0 = time.perf_counter()
    engine = engine_of(s, args)
    graphs.sync(engine.device)
    t_ctor = time.perf_counter() - t0
    facts = plan_facts(engine)
    print(f"ctor: {t_ctor:.2f} s  " + " ".join(f"{k}={v}" for k, v in facts.items()),
          flush=True)
    plan = memory_plan(engine)
    print("memory plan (the engine's tensors):", flush=True)
    for name, b in plan:
        print(f"  {name}: {_fmt_bytes(b)}", flush=True)
    if cuda:
        print(f"  allocated after the attempt's tensors are freed: "
              f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB", flush=True)
    walls, peaks = [], []
    for _ in range(2):  # cold (first launches), then warm
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = engine.optimize(engine.state, args.iters)
        graphs.sync(engine.device)
        walls.append(time.perf_counter() - t0)
        if cuda:
            peaks.append(torch.cuda.max_memory_allocated())
    chis = np.asarray(res.chis, np.float64)
    print(f"optimize({args.iters}): cold {walls[0]:.3f} s, warm {walls[1]:.3f} s, "
          f"niters {res.niters}, attempts {res.nattempts}, host reads {res.host_reads}",
          flush=True)
    print(f"chi2: {chis[0]:.6g} -> {chis[-1]:.6g}  {chis.tolist()}", flush=True)
    if cuda:
        props = torch.cuda.get_device_properties(0)
        print(f"device memory: peak {peaks[0] / 2**30:.3f} GiB (cold optimize), "
              f"{peaks[1] / 2**30:.3f} GiB (warm) of {props.total_memory / 2**30:.2f} GiB",
              flush=True)
    print("stress " + json.dumps(dict(
        P=args.poses, L=args.landmarks, E=int(nE), dtype=args.dtype, device=args.device,
        n_hpl=int(s.n_hpl), n_hsc=int(s.n_hsc), triplets=int(s.mul_i.size),
        structure_s=t_struct, ctor_s=t_ctor, **facts,
        memory_plan={name: b for name, b in plan},
        opt_cold_s=walls[0], opt_warm_s=walls[1], nattempts=int(res.nattempts),
        chis=chis.tolist(), peak_bytes=peaks or None)), flush=True)
    if chis.size == 0 or not np.all(np.isfinite(chis)):
        print(f"stress: chi2 not finite: {chis.tolist()}", file=sys.stderr)
        return 1
    if not chis[-1] < chis[0]:
        print(f"stress: chi2 did not fall: {chis.tolist()}", file=sys.stderr)
        return 1
    print("STRESS OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
