#!/usr/bin/env python3
"""Host cost of the kernel wrappers, and the segment sum at every group
width and row chunk, on one NVIDIA GPU.

    python3 cuba_tpu_torch/tools/probe_segmm.py [--root DIR]

``cuba_tpu_torch`` is imported from DIR (default: the checkout this script
lies in), so that two trees can be measured in one call, one process each;
the timing helpers and the graphs come from this checkout's
``chip_smoke.py``, ``tools/roofline.py`` and ``tools/graphs.py``
(``tools/smoke_loader.py``: one yardstick for both trees).  It prints one
``probe`` JSON line per measurement:

1. ``host_us``: microseconds of host time per call of ``gather``,
   ``segsum`` and ``trisolve.matvec`` on small inputs (so the card
   keeps up with the host), and of ``index_select`` / ``index_add_`` on the
   same inputs: 1,000 calls timed with ``time.perf_counter``, then one
   synchronise; the median of 5 such runs.
2. ``site``: each segment-sum call site of the kitti00 loop graph
   (``chip_smoke.KITTI``, v2 band plan) and the two v1 combines of the
   odometry graph with the v2 gate closed, as ``roofline.engine_sites``
   lists them (the smoke's kernel checks' sites), and the AoS pose and
   triplet sites of that graph with three loop chords, the planner closed
   (``chip_smoke.planner_closed``): its CSR's shape, and the
   device and event-timed call time (``chip_smoke.interleaved_times``) of
   the wrapper on seeded values of the site's width, beside ``index_add_``.
   Where DIR holds this design (``segmm.row_chunk``), also of the kernel at
   every group width G and row chunk R (``G4R3``), where more than half
   the segments are empty with the list of the others (``L``) as well, and
   the G and R the wrapper picks (``rule``).
3. ``empty``: at the v1 combines' shape (1,982,464 segments) and D = 18
   and 36, for a share of empty segments from 50% to 99% (the others of 1
   or 10 entries each, columns in seeded random order), the kernel with
   the list of the non-empty segments and without, each at the G and R the
   rules give for the mean length it walks.
"""

import argparse
import json
import os
import statistics
import sys
import time

import smoke_loader  # this checkout's, from the script's directory


def emit(**kw):
    print("probe " + json.dumps(kw), flush=True)


def host_us(fn, torch, calls=1000, runs=5):
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        per.append(1e6 * (time.perf_counter() - t0) / calls)
    return statistics.median(per)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=smoke_loader.REPO)
    args = ap.parse_args()
    smoke = smoke_loader.load_smoke(args.root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("probe_segmm: needs a CUDA device")
    from cuba_tpu_torch import BAConfig
    from cuba_tpu_torch.io import synthetic
    from cuba_tpu_torch.ops import cudalib, segmm
    from cuba_tpu_torch.solver import trisolve

    tree = os.path.abspath(args.root)
    segmm.build_kernels()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def draw(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    # 1. host cost per wrapper call
    ids = torch.randint(0, 1024, (4096,), generator=gen, device=dev, dtype=torch.int32)
    src, vals = draw(12, 1024), draw(18, 4096)
    csr = segmm.segment_csr(ids, 1024, dev)
    A, x = draw(256, 256), draw(256)
    idx = ids.long()
    calls = {
        "gather": lambda: segmm.gather(src, ids),
        "segsum": lambda: segmm.segsum(vals, ids, 1024, csr),
        "matvec": lambda: trisolve.matvec(A, x),
        "index_select": lambda: src.index_select(1, idx),
        "index_add_": lambda: torch.zeros((18, 1024), device=dev).index_add_(1, idx, vals),
    }
    for name, fn in calls.items():
        emit(tree=tree, host_us=name, us=host_us(fn, torch))

    # 2. the segment-sum sites of the kitti00 loop graph (v2), the odometry
    # graph with the v2 gate closed (v1) and with three chords (AoS)
    from cuba_tpu_torch.solver import rows

    def engine(prob):
        ba = smoke.make_graph(prob, BAConfig(dtype=torch.float32, device="cuda"))
        ba.initialize()
        return ba._engine

    def segsum_sites(eng, prefix=""):
        """{label: (ids, num_out, D, csr)} of the engine's segment-sum
        sites (``roofline.engine_sites``, the smoke's and ``mfu``'s)."""
        out = {}
        for label, site in smoke.roofline.engine_sites(eng).items():
            if site.kind == "segsum":
                vals, ids, num_out, csr = site.inputs
                out[prefix + label] = (ids, num_out, vals.shape[0], csr)
        return out

    sites = segsum_sites(engine(synthetic.generate(**smoke.KITTI)))
    oprob = synthetic.generate(**smoke.KITTI00)
    wg_max, rows._WG_MAX = rows._WG_MAX, 0
    try:
        eng = engine(oprob)
    finally:
        rows._WG_MAX = wg_max
    sites.update({k: v for k, v in segsum_sites(eng, "v1 ").items() if "combine" in k})
    with smoke.planner_closed():
        eng = engine(smoke.with_chords(oprob, 3))
    sites["aos_pose"] = (eng.edges[0].pose_idx, eng.num_p, 42, eng.edges[0].csr_pose)
    sites["aos_triplets"] = (eng.sc.mul_k, eng.sc.hsc_row.shape[0], 36, eng.sc.csr_mul)
    del eng

    def raw_segsum(vals, num_out, csr, group, rows_per_chunk, live):
        """The kernel at a given group width, row chunk and live-segment
        list (or None), past the wrapper's choice of all three."""
        out = torch.empty((vals.shape[0], num_out), device=dev)
        cudalib.call("probe", vals, segmm._kernel_lib().cuba_segsum_csr, vals.data_ptr(),
                     csr.order.data_ptr(), csr.offs.data_ptr(),
                     None if live is None else live.data_ptr(),
                     0 if live is None else live.numel(), out.data_ptr(), vals.shape[0],
                     vals.shape[1], num_out, group, rows_per_chunk)
        return out

    sweep = hasattr(segmm, "row_chunk")
    for site, (ids, num_out, D, csr) in sites.items():
        vals = draw(D, ids.shape[0])
        valid = (ids >= 0) & (ids < num_out)
        idx, v = ids[valid].long(), vals[:, valid].contiguous()
        lengths = np.diff(csr.offs.cpu().numpy())
        fns = {"wrapper": lambda c=csr, ids=ids, vals=vals, num_out=num_out: segmm.segsum(
            vals, ids, num_out, c)}
        rule = {}
        if sweep:
            rule = dict(group=csr.group, rows=segmm.row_chunk(D, vals.shape[1], csr.group),
                        listed=csr.live is not None)
            live = torch.from_numpy(np.flatnonzero(lengths).astype(np.int32)).to(dev)
            for g in (1, 2, 4, 8, 16, 32):
                for r in range(1, segmm.MAX_ROWS + 1):
                    for lv in ((None, live) if lengths.size > 2 * live.numel() else (None,)):
                        if r <= D:
                            fns[f"{'L' if lv is not None else ''}G{g}R{r}"] = (
                                lambda vals=vals, num_out=num_out, c=csr, g=g, r=r, lv=lv:
                                raw_segsum(vals, num_out, c, g, r, lv))
        fns["index_add_"] = lambda idx=idx, v=v, D=D, num_out=num_out: torch.zeros(
            (D, num_out), device=dev).index_add_(1, idx, v)
        times = smoke.interleaved_times(fns, torch)
        emit(tree=tree, site=site, D=D, segments=num_out, entries=int(lengths.sum()),
             mean=float(lengths.mean()), max=int(lengths.max()),
             empty=float((lengths == 0).mean()), rule=rule,
             times={k: {"ms": ms, "device_ms": dms} for k, (ms, dms) in times.items()})
    if not sweep:
        return

    # 3. listed against unlisted by the share of empty segments
    rng = np.random.default_rng(0)
    num_out = 1_982_464
    for length in (1, 10):
        for D in (18, 36):
            for empty in (0.5, 0.75, 0.9, 0.95, 0.98, 0.99):
                n_live = int(round((1 - empty) * num_out))
                live_np = np.sort(rng.choice(num_out, n_live, replace=False))
                ids = torch.from_numpy(rng.permutation(np.repeat(live_np, length)).astype(
                    np.int32)).to(dev)
                csr = segmm.segment_csr(ids, num_out, dev)
                live = torch.from_numpy(live_np.astype(np.int32)).to(dev)
                vals = draw(D, ids.shape[0])
                fns, picks = {}, {}
                for name, lv, mean in (("unlisted", None, n_live * length / num_out),
                                       ("listed", live, length)):
                    g = segmm.group_width(mean)
                    r = segmm.row_chunk(D, vals.shape[1], g)
                    picks[name] = f"G{g}R{r}"
                    fns[name] = (lambda vals=vals, c=csr, g=g, r=r, lv=lv:
                                 raw_segsum(vals, num_out, c, g, r, lv))
                times = smoke.interleaved_times(fns, torch)
                emit(tree=tree, empty=empty, length=length, D=D, segments=num_out, picks=picks,
                     rule_listed=csr.live is not None,
                     times={k: {"ms": ms, "device_ms": dms} for k, (ms, dms) in times.items()})
                del ids, csr, live, vals


if __name__ == "__main__":
    main()
