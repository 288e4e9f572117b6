#!/usr/bin/env python3
"""The v2 Schur formation's three kernels, ``schur_fused``,
``compact_to_band`` and ``compact_to_dense``, beside their plain versions,
warm and cold, on one NVIDIA GPU.

    python3 cuba_tpu_torch/tools/probe_schur.py [--root DIR] [--kernels K ...]

``cuba_tpu_torch`` is imported from DIR (default: the checkout this script
lies in), so that two trees can be measured in one call, one process each;
the timing helpers, the bound and the graphs come from this checkout's
``chip_smoke.py``, ``tools/roofline.py`` and ``tools/graphs.py``
(``tools/smoke_loader.py``: one yardstick for both trees).  The call sites
are the engine's: for the kitti00 loop graph (``chip_smoke.KITTI``,
``band_cr``: ``schur_fused``, ``compact_to_band``), kitti07
(``chip_smoke.KITTI07``, ``dense_cholesky``: all three) and the kitti00
loop graph built ``dense_cholesky`` (n = 8448: ``compact_to_dense``), each
built through the public API and initialized, the first damped attempt's
W, Hpl, compact table and damped diagonal (``roofline.first_attempt``) go
through ``rows.schur_compact``'s, ``rows.band_from_compact``'s and
``rows.dense_from_compact``'s calls (``--kernels`` keeps only the named
kernels, and the graphs they run on).  It prints one ``probe`` JSON line
per kernel, graph and cache regime (``chip_smoke.interleaved_times``:
``warm``, each call after an untimed run of itself; ``cold``, after a 128
MB read): the device and event-timed call time of the wrapper and of the
plain version, the bound (``roofline.bound``) and the plan's shape.  The
``schur_fused`` line also times the wrapper on two changed inputs that
split its time: ``no_sums``, every lane's CSR segment empty (offsets all
0), so that the kernel stages its windows and tables and stores its output
but sums nothing; and ``hot_windows``, every chunk's window at slot 0 (sb
all 0), so that the staging reads one window the L2 holds and the sums are
the same.  Where DIR has them (``segmm.schur_fused_launch``,
``segmm.compact_to_dense_launch``), the lines give the launches and the
build's registers, spills and blocks an SM.
"""

import argparse
import json
import os
import sys

import smoke_loader  # this checkout's, from the script's directory

KERNELS = ("schur_fused", "compact_to_band", "compact_to_dense")


def emit(**kw):
    print("probe " + json.dumps(kw), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=smoke_loader.REPO)
    ap.add_argument("--kernels", nargs="+", default=list(KERNELS), choices=KERNELS)
    args = ap.parse_args()
    smoke = smoke_loader.load_smoke(args.root)

    import torch

    if not torch.cuda.is_available():
        sys.exit("probe_schur: needs a CUDA device")
    from cuba_tpu_torch import BAConfig
    from cuba_tpu_torch.io import synthetic
    from cuba_tpu_torch.ops import segmm
    from cuba_tpu_torch.solver import rows

    tree = os.path.abspath(args.root)
    segmm.build_kernels()
    design = hasattr(segmm, "schur_fused_launch")

    def report(kernel, graph, fns, work, shape):
        for cold in (False, True):
            times = smoke.interleaved_times(fns, torch, cold=cold)
            emit(tree=tree, kernel=kernel, graph=graph, cache="cold" if cold else "warm",
                 bound_ms=smoke.roofline.bound(*work)[0], **shape,
                 times={k: {"ms": ms, "device_ms": dms} for k, (ms, dms) in times.items()})

    graphs = (("kitti00-loop", smoke.KITTI, "auto", ("schur_fused", "compact_to_band")),
              ("kitti07", smoke.KITTI07, "auto", KERNELS),
              ("dense-kitti00", smoke.KITTI, "dense_cholesky", ("compact_to_dense",)))
    for graph, params, solver, kernels in graphs:
        kernels = [k for k in kernels if k in args.kernels]
        if not kernels:
            continue
        ba = smoke.make_graph(synthetic.generate(**params),
                              BAConfig(dtype=torch.float32, solver=solver, device="cuda"))
        ba.initialize()
        engine = ba._engine
        plan, rc = engine.plan, engine.rc
        HppT, HplT, lam, W, _bscT = smoke.roofline.first_attempt(engine)
        sc = (plan.schur, rc.sc_sb, rc.sc_li, rc.sc_lj, rc.sc_lk)
        p = plan.schur
        if "schur_fused" in kernels:
            lengths = torch.diff(rc.csr_sc.offs)
            shape = dict(solver=engine.solver, chunks=p.num_chunks, chunk=p.chunk, kwin=p.kwin,
                         triplets=int(rc.csr_sc.offs[-1]), lanes_used=int((lengths > 0).sum()),
                         max_lane=int(lengths.max()))
            empty = rc.csr_sc._replace(offs=torch.zeros_like(rc.csr_sc.offs))
            sb0 = torch.zeros_like(rc.sc_sb)
            fns = {"wrapper": lambda: segmm.schur_fused(W, HplT, *sc, csr=rc.csr_sc),
                   "plain": lambda: segmm.schur_fused_plain(W, HplT, *sc),
                   "no_sums": lambda: segmm.schur_fused(W, HplT, *sc, csr=empty),
                   "hot_windows": lambda: segmm.schur_fused(W, HplT, p, sb0, *sc[2:],
                                                            csr=rc.csr_sc)}
            if design:
                launch = segmm.schur_fused_launch(p)
                shape["launch"] = {**launch, **segmm.kernel_attributes("schur_fused", launch)}
            report("schur_fused", graph, fns, smoke.roofline.schur_work(p, sc, rc.csr_sc), shape)

        PB = plan.pad_blocks
        gT = rows.schur_compact(W, HplT, plan, rc)
        dbT = rows.damped_diagonal_T(HppT, lam, engine.num_p, PB)
        slots = int((rc.iru >= 0).sum())
        if "compact_to_band" in kernels:
            band = (gT, rc.iru, rc.icu, dbT, rc.band_occ, PB, plan.wg)
            shape = dict(solver=engine.solver, PB=PB, wg=plan.wg,
                         occupied_tiles=int((rc.band_occ > 0).sum()), slots=slots)
            if design:
                launch = segmm.compact_to_band_launch(PB)
                shape["launch"] = {**launch,
                                   **segmm.kernel_attributes("compact_to_band", launch)}
            report("compact_to_band", graph, {
                "wrapper": lambda: segmm.compact_to_band(*band, table=rc.band_table),
                "plain": lambda: segmm.compact_to_band_plain(*band)},
                smoke.roofline.band_work(plan, rc), shape)
        if "compact_to_dense" in kernels:
            dense = (gT, rc.iru, rc.icu, dbT, rc.occ2, PB, plan.wg)
            shape = dict(solver=engine.solver, PB=PB, wg=plan.wg,
                         occupied_tiles=int((rc.occ2 > 0).sum()), slots=slots)
            if hasattr(segmm, "compact_to_dense_launch"):
                launch = segmm.compact_to_dense_launch(PB)
                shape["launch"] = {**launch,
                                   **segmm.kernel_attributes("compact_to_dense", launch)}
            report("compact_to_dense", graph, {
                "wrapper": lambda: segmm.compact_to_dense(*dense, table=rc.dense_table),
                "plain": lambda: segmm.compact_to_dense_plain(*dense)},
                smoke.roofline.dense_work(plan, rc), shape)
        del ba, engine, W, HplT, gT, dbT

if __name__ == "__main__":
    main()
