"""The host split of ``initialize()``: where the seconds between a built
graph and an engine ready to optimize go, span by span.

    python -m cuba_tpu_torch.tools.profile_ctor [--graph kitti00-loop|stress|kitti07]
        [--poses P] [--landmarks L] [--trials 2] [--dtype float32] [--device cuda|cpu]

For each trial a fresh graph is built through the public API (not timed)
and ``initialize()`` runs under ``torch.profiler`` (host activity).  The
port's own spans (``cuba_tpu_torch/trace.py``) split it: the symbolic pass
(``structure``: the graph arrays, ``structure.band_perm``,
``structure.locality``, ``structure.symbolic``) and the engine
(``engine``: ``engine.resolve``, ``engine.plan_rows`` with
``plan.row_tables`` and ``plan.schur_lane_csr``, and ``engine.upload``,
the host-to-device copies).  Each step is printed with its host seconds
and its own (less its child spans'); the two root spans' own seconds are
printed as unattributed, with their share of the ``initialize()`` wall, and
what lies outside both (the API's edge list) as outside.  Then the first
residual (``edge_rows`` on the initial state, the first device work on the
new tables) is timed after ``initialize()``.  One ``ctor`` JSON line a
trial.  On the card by default; without one it fails (pass ``--device
cpu`` for the host).
"""

import argparse
import json
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from cuba_tpu_torch import native
from cuba_tpu_torch.config import BAConfig
from cuba_tpu_torch.io import synthetic
from cuba_tpu_torch.tools import graphs

ROOTS = ("structure", "engine")  # initialize()'s spans
WHAT = {  # what each step does, as printed
    "structure.band_perm": "pose band permutation",
    "structure.locality": "landmark locality reorder",
    "structure.symbolic": "symbolic pass (C++ or NumPy)",
    "engine.resolve": "band certification, loop plan, solver",
    "engine.plan_rows": "row plan: band / dense tables, segment CSRs",
    "plan.row_tables": "paddings, window plans, Schur plan",
    "plan.schur_lane_csr": "schur_fused's lane CSR",
    "engine.upload": "host-to-device copies",
}


def _union(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def split(spans):
    """{name: (seconds, own seconds)} of ``[(name, start us, end us)]``:
    the union of a name's intervals, and that less the union of the other
    spans that lie inside them (its children)."""
    out = {}
    for name in sorted({n for n, _a, _b in spans}):
        mine = [(a, b) for n, a, b in spans if n == name]
        inner = [(a, b) for n, a, b in spans if n != name
                 and any(a0 <= a and b <= b0 and (a, b) != (a0, b0) for a0, b0 in mine)]
        total = _union(mine)
        out[name] = (total / 1e6, (total - _union(inner)) / 1e6)
    return out


def trial(prob, config):
    """One trial: {"spans": [(name, start us, end us)], "steps": {name:
    [s, own s]}, "wall": s, "unattributed": s, "outside": s,
    "first_residual": s, "route": ...}."""
    ba = graphs.make_graph(prob, config)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        ba.initialize()
        graphs.sync(config.device)
        wall = time.perf_counter() - t0
    spans = [(e.name[5:], e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CPU and e.name.startswith("cuba.")]
    eng = ba._engine
    t0 = time.perf_counter()
    eng._residuals_and_chi(eng.state)
    graphs.sync(eng.device)
    first = time.perf_counter() - t0
    by_name = split(spans)
    roots = [(a, b) for n, a, b in spans if n in ROOTS]
    steps = {n: list(v) for n, v in sorted(by_name.items(), key=lambda kv: -kv[1][0])
             if n not in ROOTS}
    return dict(spans=spans, steps=steps, wall=wall,
                unattributed=sum(by_name[n][1] for n in ROOTS if n in by_name),
                outside=wall - _union(roots) / 1e6, first_residual=first, route=eng.path,
                solver=eng.solver, symbolic=native.backend())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    graphs.add_graph_args(ap, "kitti00-loop")
    ap.add_argument("--trials", type=int, default=2)
    graphs.add_device_args(ap)
    args = ap.parse_args(argv)
    params = graphs.graph_params(args.graph, args)
    config = BAConfig(dtype=getattr(torch, args.dtype), device=args.device)
    print(f"device: {graphs.card(args.device)}", flush=True)
    prob = synthetic.generate(**params)
    # the first initialize() of a process also starts the device and loads
    # the symbolic pass: unprofiled
    warm = graphs.make_graph(prob, config)
    warm.initialize()
    del warm
    for k in range(args.trials):
        r = trial(prob, config)
        share = r["unattributed"] / r["wall"]
        print(f"trial {k} ({args.graph}, P {params['num_poses']}, L {params['num_landmarks']}, "
              f"{r['route']} {r['solver']}, symbolic {r['symbolic']}): initialize() "
              f"{r['wall']:.4f} s under the profiler; unattributed (the root spans' own) "
              f"{r['unattributed']:.4f} s ({100 * share:.2f}%), outside the spans "
              f"{r['outside']:.4f} s; first residual {r['first_residual']:.4f} s", flush=True)
        for name, (sec, own) in r["steps"].items():
            print(f"  {name} ({WHAT.get(name, '')}): {sec:.4f} s, own {own:.4f} s "
                  f"({100 * sec / r['wall']:.1f}%)", flush=True)
        del r["spans"]
        print("ctor " + json.dumps(dict(graph=args.graph, trial=k, **params, **r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
