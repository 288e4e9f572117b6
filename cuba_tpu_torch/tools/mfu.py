"""The roofline table of the port's hand-written kernels at their call
sites on one graph: for each site, the kernel's device time against the
least time its work could take on the card.

    python -m cuba_tpu_torch.tools.mfu [--stress] [--poses P] [--landmarks L]
        [--dtype float32|float64] [--device cuda|cpu]

The graph (the kitti00 loop by default, ``--stress`` for 1778 P / 1M L) is
built through the public API and initialized; one counted ``optimize(10)``
gives each kernel's launches per damped attempt.  The sites are
``roofline.engine_sites``, those of ``chip_smoke.py``'s kernel checks: on
the engine's initial state the pose fetch, the per-slot gather, the mono
pose sums and Hpl-slot sums; on the first damped attempt ``schur_fused``, the combine and
``compact_to_band`` or ``compact_to_dense``.  Work counts and the bound
are ``roofline``'s, the smoke's ``bound_ms`` column; the device times are
``roofline.interleaved_times``' (median over 25 calls, warm: after an
untimed run of the call; cold: after a 128 MB read).  Per site it prints
bytes, achieved GB/s and its share of 3.35 TB/s, and where operations
bound the kernel, its rate against the fp32 (67 TFLOP/s) or fp64 (34
TFLOP/s) peak; then a markdown table and one ``mfu`` JSON line a site.
With ``--device cpu`` the times are host times of the plain versions (no
device metric).
"""

import argparse
import json
import sys

import torch

from cuba_tpu_torch.config import BAConfig
from cuba_tpu_torch.io import synthetic
from cuba_tpu_torch.ops import cudalib, segmm
from cuba_tpu_torch.tools import graphs, roofline

ITERS = 10


def table(engine, launches, attempts):
    """The rows of the roofline table: one dict a site."""
    fp64 = engine.dtype == torch.float64
    peak = roofline.FP64_FLOPS_PER_MS if fp64 else roofline.FP32_FLOPS_PER_MS
    s = roofline.engine_sites(engine)
    fns = {k: (lambda site=site: site.call(site.wrapper())) for k, site in s.items()}
    cuda = engine.device.type == "cuda"
    if cuda:
        warm = roofline.interleaved_times(fns)
        cold = roofline.interleaved_times(fns, cold=True)
        times = {k: (warm[k][1], cold[k][1]) for k in fns}
    else:
        times = {k: (v, None) for k, v in roofline.host_times(fns).items()}
    out = []
    for label, site in s.items():
        kernel, (nbytes, flops) = site.kernel, site.work()
        ms, cold_ms = times[label]
        bound_ms, bound_by = roofline.bound(nbytes, flops, fp64)
        # rates only from device times: a host time of the CPU's plain
        # version is no device metric
        dev = ms if cuda else None
        ops = cuda and bound_by == "operations"
        out.append(dict(
            site=label, kernel=kernel, launches_per_attempt=launches[kernel] / max(attempts, 1),
            device_ms=dev, cold_device_ms=cold_ms, host_ms=None if cuda else ms,
            bytes=nbytes, flops=flops,
            gbs=nbytes / dev / 1e6 if cuda else None,
            hbm_share=nbytes / dev / roofline.HBM_BYTES_PER_MS if cuda else None,
            gflops=flops / dev / 1e6 if ops else None,
            peak_share=flops / dev / peak if ops else None,
            bound_ms=bound_ms, bound_by=bound_by, over_bound=dev / bound_ms if cuda else None))
    return out


def print_table(rows_, title):
    print(f"\n{title}\n", flush=True)
    time_col = "device ms warm / cold" if rows_ and rows_[0]["device_ms"] is not None else \
        "host ms (CPU, plain versions; not a device time)"
    print(f"| site | launches / attempt | {time_col} | MB | GB/s | of 3.35 TB/s | GFLOP/s "
          "| of peak | bound ms (by) | time / bound |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for r in rows_:
        ms = r["device_ms"] if r["device_ms"] is not None else r["host_ms"]
        t = f"{ms:.4f}" + (f" / {r['cold_device_ms']:.4f}" if r["cold_device_ms"] else "")
        ops = ("–", "–") if r["gflops"] is None else (f"{r['gflops']:.1f}",
                                                      f"{100 * r['peak_share']:.1f}%")
        rate = ("–", "–", "–") if r["gbs"] is None else (
            f"{r['gbs']:.1f}", f"{100 * r['hbm_share']:.1f}%", f"{r['over_bound']:.2f}x")
        print(f"| {r['site']} | {r['launches_per_attempt']:.1f} | {t} | {r['bytes'] / 1e6:.3f} "
              f"| {rate[0]} | {rate[1]} | {ops[0]} | {ops[1]} "
              f"| {r['bound_ms']:.4f} ({r['bound_by']}) | {rate[2]} |", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stress", action="store_true",
                    help="the stress graph (default: the kitti00 loop)")
    graphs.add_size_args(ap)
    graphs.add_device_args(ap)
    args = ap.parse_args(argv)
    graph = "stress" if args.stress else "kitti00-loop"
    params = graphs.graph_params(graph, args)
    card = graphs.card(args.device)
    config = BAConfig(dtype=getattr(torch, args.dtype), device=args.device)
    ba = graphs.make_graph(synthetic.generate(**params), config)
    ba.initialize()
    engine = ba._engine
    if engine.device.type == "cuda":
        segmm.build_kernels()
    cudalib.reset_launches()
    ba.optimize(ITERS)
    graphs.sync(engine.device)
    launches, attempts = dict(cudalib.LAUNCHES), ba.last_result.nattempts
    print(f"graph {graph}: P {params['num_poses']}, L {params['num_landmarks']}, "
          f"route {engine.path}, solver {engine.solver}, band_m {engine.band_m}, PB "
          f"{engine.pad_blocks}, {args.dtype}; counted optimize({ITERS}): {attempts} attempts; "
          f"{card}", flush=True)
    rows_ = table(engine, launches, attempts)
    print_table(rows_, f"roofline ({graph}, {args.dtype}, {card})")
    for r in rows_:
        print("mfu " + json.dumps(dict(graph=graph, dtype=args.dtype, **r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
