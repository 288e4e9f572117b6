"""The host split of ``initialize()``: where the seconds between a built
graph and an engine ready to optimize go, step by step.

    python -m cuba_tpu_torch.tools.profile_ctor [--graph kitti00-loop|stress|kitti07]
        [--poses P] [--landmarks L] [--trials 2] [--dtype float32] [--device cuda|cpu]

For each trial a fresh graph is built through the public API (not timed)
and ``initialize()`` runs with each of its steps timed on the host clock:
every step is a function of the port, wrapped for the trial, and charged
its own time less that of the steps it calls (a device step ends in a
synchronize).  The steps:

- graph arrays: ``build_structure``'s walk over the vertices and edges;
- pose band permutation and landmark locality reorder (the symbolic
  pass's two reorders) and the symbolic pass itself (C++, ``native.py``,
  or NumPy), then the structure's assembly;
- ``resolve_solver``: band certification, the loop plan, the solver;
- ``rows.plan_rows``: the row tables (the paddings and padded id tables
  of ``plan_row_tables``), the window plans (``plan_tiles``,
  ``plan_gather_tiles``, ``plan_accum_windows``), the Schur plan
  (``plan_schur_for``), ``segmm.schur_lane_csr``, the band or dense
  tables, the segment sums' CSRs (built on the host and uploaded), and
  the upload of the other tables (``plan_rows``' own time and the
  engine's state and cameras);
- the edge list ``initialize()`` keeps for ``chi_squared``.

What no step accounts for is printed as unattributed; the run fails unless
the steps sum to within 5% of the ``initialize()`` wall of the same trial.
Then the first residual (``edge_rows`` on the initial state, the first
device work on the new tables) is timed after ``initialize()``.  One
``ctor`` JSON line a trial.  On the card by default; without one it fails
(pass ``--device cpu`` for the host).
"""

import argparse
import contextlib
import functools
import json
import sys
import time

import torch

from cuba_tpu_torch import native
from cuba_tpu_torch.config import BAConfig
from cuba_tpu_torch.io import synthetic
from cuba_tpu_torch.models import graph
from cuba_tpu_torch.ops import segmm
from cuba_tpu_torch.solver import engine as engine_mod
from cuba_tpu_torch.solver import rows, structure
from cuba_tpu_torch.tools import graphs

TOLERANCE = 0.05  # the steps must sum to within this share of the wall

# (module, function name, step, device step): the functions timed; a
# function's time less that of the timed functions it calls is its step's
STEPS = (
    (graph, "build_structure", "graph arrays", False),
    (structure, "_pose_band_perm", "pose band permutation", False),
    (structure, "_locality_reorder", "landmark locality reorder", False),
    (native, "symbolic_compile", "symbolic pass (C++)", False),
    (structure, "_symbolic_numpy", "symbolic pass (NumPy)", False),
    (structure, "_finish_structure", "structure assembly", False),
    (engine_mod, "resolve_solver", "resolve_solver", False),
    (rows, "plan_row_tables", "row tables", False),
    (segmm, "plan_tiles", "window plans", False),
    (segmm, "plan_gather_tiles", "window plans", False),
    (segmm, "plan_accum_windows", "window plans", False),
    (rows, "plan_schur_for", "Schur plan", False),
    (segmm, "schur_lane_csr", "schur_lane_csr", True),
    (rows, "_band_tables", "band / dense tables", False),
    (rows, "_v1_tables", "band / dense tables", False),
    (segmm, "band_table", "band / dense tables", False),
    (segmm, "dense_table", "band / dense tables", False),
    (segmm, "segment_csr", "segment CSRs", True),
    (rows, "plan_rows", "upload", True),
    (engine_mod.BlockSolverEngine, "_setup", "upload", True),
    (graph.BundleAdjustment, "_active_edges", "edge list", False),
)
# functions whose callees are charged to them (schur_lane_csr builds its
# CSR with segment_csr)
ABSORB = {"schur_lane_csr"}


class StepClock:
    """Self times by step of the wrapped functions of one trial."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.seconds = {}
        self.stack = []  # [step, seconds of the timed callees]

    def wrap(self, fn, step, device_step, absorb, materialize):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            if self.stack and self.stack[-1][0] in ABSORB:
                return fn(*args, **kwargs)
            self.stack.append([step, 0.0])
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                if materialize:  # a generator: its work is done while it is walked
                    out = list(out)
                if device_step and self.cuda:
                    torch.cuda.synchronize()
            finally:
                total = time.perf_counter() - t0
                _step, inner = self.stack.pop()
                self.seconds[step] = self.seconds.get(step, 0.0) + total - inner
                if self.stack:
                    self.stack[-1][1] += total
            return out
        return timed

    @contextlib.contextmanager
    def installed(self):
        saved = []
        try:
            for owner, name, step, device_step in STEPS:
                fn = getattr(owner, name)
                saved.append((owner, name, fn))
                setattr(owner, name, self.wrap(fn, step, device_step, step in ABSORB,
                                               name == "_active_edges"))
            yield self
        finally:
            for owner, name, fn in reversed(saved):
                setattr(owner, name, fn)


def trial(prob, config):
    """One trial: {"steps": {step: s}, "wall": s, "unattributed": s,
    "first_residual": s, "route": ...}."""
    ba = graphs.make_graph(prob, config)
    clock = StepClock(config.device)
    with clock.installed():
        t0 = time.perf_counter()
        ba.initialize()
        wall = time.perf_counter() - t0
    eng = ba._engine
    t0 = time.perf_counter()
    eng._residuals_and_chi(eng.state)
    graphs.sync(eng.device)
    first = time.perf_counter() - t0
    steps = dict(sorted(clock.seconds.items(), key=lambda kv: -kv[1]))
    return dict(steps=steps, wall=wall, unattributed=wall - sum(steps.values()),
                first_residual=first, route=eng.path, solver=eng.solver,
                symbolic=native.backend())


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
    # the symbolic pass: untimed
    warm = graphs.make_graph(prob, config)
    warm.initialize()
    del warm
    ok = True
    for k in range(args.trials):
        r = trial(prob, config)
        share = abs(r["unattributed"]) / r["wall"]
        ok &= share <= TOLERANCE
        print(f"trial {k} ({args.graph}, P {params['num_poses']}, L {params['num_landmarks']}, "
              f"{r['route']} {r['solver']}, symbolic {r['symbolic']}): initialize() "
              f"{r['wall']:.4f} s; steps sum {sum(r['steps'].values()):.4f} s, unattributed "
              f"{r['unattributed']:.4f} s ({100 * share:.2f}%, at most {100 * TOLERANCE:.0f}%); "
              f"first residual {r['first_residual']:.4f} s", flush=True)
        for step, sec in r["steps"].items():
            print(f"  {step}: {sec:.4f} s ({100 * sec / r['wall']:.1f}%)", flush=True)
        print("ctor " + json.dumps(dict(graph=args.graph, trial=k, **params, **r)), flush=True)
    if not ok:
        print("profile_ctor: the steps do not sum to the initialize() wall", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
