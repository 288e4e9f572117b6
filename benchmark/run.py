"""The port's benchmark: one cell of ``BENCHMARK.json``, one run.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (``benchmark/configs/<name>.json``: the
generator's parameters of a public BA deployment, the LM settings and the
Huber thresholds) and a traffic mix (``benchmark/traffic/<name>.json``,
read by ``traffic.py``).  Every metric is a reader of its own,
``benchmark/metrics/<name>.py``, with a ``read(run)`` that returns a number
or None (nothing to read: the metric is left out of the line).

A run: set-up (imports, the problem generated from the seed, for a
``solve`` mix the structure and the engine, the warm-up requests), then a
closed loop of one client sending requests back to back for ``--seconds``,
then with ``--trace 1`` a few more requests under ``torch.profiler``, then
the check of the window's answers against the plain reference
(``compare.py``).  The last line of standard output is the result, a JSON
object; with ``--trace 0`` its metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics.

It runs on the card and fails without one (or with fewer cards than the
cell asks for), and fails if ``jax``, ``jaxlib``, ``flax`` or ``cuba_tpu``
was imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "cuba_tpu")
TRACE_REQUESTS = 2  # traced after the window: device only, then device and host
CHECKED_FRESH = 2  # fresh answers the check compares, drawn from the seed


def forbidden_modules(names) -> list:
    """The top-level names of ``names`` (module names) that are in
    :data:`FORBIDDEN`, compared whole: ``cuba_tpu_torch`` is not
    ``cuba_tpu``."""
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_bench(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(root, c["file"]))
    raise SystemExit(f"no config {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a cell reports: its end-to-end metrics, or with
    ``trace`` its per-layer ones (a metric without ``workloads`` goes to
    every cell that reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def load_reader(name: str, root: str = HERE):
    """The ``read`` of ``metrics/<name>.py``.  A reader that sets
    ``read.device_trace`` reads the traced solve request, which a run then
    makes after its window with ``--trace 0`` too."""
    path = os.path.join(root, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_check(chips: int):
    """None, or why the run cannot measure: no card, or fewer than the
    cell asks for."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is False: the benchmark runs on the card only"
    if torch.cuda.device_count() < chips:
        return f"the cell asks for {chips} cards and torch sees {torch.cuda.device_count()}"
    return None


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else "not read"


class GcClock:
    """The time Python's cyclic collector takes, and its collections by
    generation, from ``gc.callbacks``: the program's own collections fall
    inside the requests' walls, and the run reports them beside the walls
    (``gc_s`` a request, ``gc_in_window``) so that a slow request can be
    told from a collection."""

    def __init__(self):
        self.seconds, self.collections, self._t = 0.0, [0, 0, 0], None
        gc.callbacks.append(self._callback)

    def _callback(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.collections[info["generation"]] += 1
            self._t = None

    def snapshot(self):
        return self.seconds, list(self.collections)

    def since(self, snap) -> dict:
        s0, c0 = snap
        return {"seconds": self.seconds - s0,
                "collections": [a - b for a, b in zip(self.collections, c0)]}

    def close(self) -> None:
        if self._callback in gc.callbacks:
            gc.callbacks.remove(self._callback)


def cpu_mhz():
    """The mean clock of the host's cores by ``/proc/cpuinfo``, or None
    where it is not there."""
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f if line.startswith("cpu MHz")]
    except (OSError, ValueError, IndexError):
        return None
    return sum(mhz) / len(mhz) if mhz else None


def gpu_clocks() -> str:
    """The card's SM clock, its maximum, its temperature and power draw by
    ``nvidia-smi``, or "not read"."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
                              "temperature.gpu,power.draw", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else "not read"


class Run:
    """One run of a cell: its set-up, its window and its traced requests."""

    def __init__(self, cell: str, cfg: dict, mix, seed: int, device: str, trace: bool):
        from benchmark import program, traffic

        self.cell, self.cfg, self.mix, self.seed = cell, cfg, mix, seed
        self.device, self.trace = device, trace
        self.program, self.traffic = program, traffic
        self.config = program.make_config(cfg, mix.dtype, device)
        self.records, self.traced, self.traced_records = [], {}, {}
        self.window_s = self.setup_s = 0.0
        self.peak_bytes = 0
        self.built = program.libraries_built()
        self._work = None
        self.gc_clock = GcClock()
        self.gc_window, self.cpu_mhz, self.gpu_clocks = {}, [], []

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        self.base = self.traffic.base_problem(self.cfg, self.seed)
        if self.mix.kind == "solve":
            self.structure = self.program.structure(self.base)
            self.engine = self.program.engine(self.structure, self.cfg["huber_deltas"],
                                              self.config)
        for k in range(self.traffic.WARMUP_REQUESTS):
            self.request(k)
        self.next_k = self.traffic.WARMUP_REQUESTS

    # -- requests -------------------------------------------------------------

    def problem(self, k: int):
        if self.mix.kind == "solve":
            return self.base
        return self.traffic.fresh_request(self.base, self.cfg, self.mix, self.seed, k)

    def _sync(self) -> None:
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()

    def request(self, k: int, marks: bool = False, timer=None) -> dict:
        """Request ``k``: its problem prepared, then the timed steps (1-2 for
        a fresh mix, 3-4 always).  Returns its record: ``wall_s``, the
        program's counters and the answer.  ``timer`` wraps the timed steps
        (the profiler's)."""
        from torch.autograd.profiler import record_function

        from benchmark.trace import RANGE_PREFIX

        prog, rec = self.program, {"k": k}
        prob = self.problem(k)

        def timed():
            gc0 = self.gc_clock.seconds
            c0 = time.thread_time()
            t0 = time.perf_counter()
            if self.mix.kind == "fresh":
                with record_function(RANGE_PREFIX + "structure"):
                    s = prog.structure(prob)
                t1 = time.perf_counter()
                with record_function(RANGE_PREFIX + "engine"):
                    eng = prog.engine(s, self.cfg["huber_deltas"], self.config)
                if self.trace:
                    self._sync()
                t2 = time.perf_counter()
                rec.update(structure_s=t1 - t0, ctor_s=t2 - t1)
            else:
                s, eng = self.structure, self.engine
            pm = prog.phase_marks(eng) if marks else None
            with record_function(RANGE_PREFIX + "optimize"):
                res, host = prog.solve(eng, self.cfg["iterations"], pm)
            rec["wall_s"] = time.perf_counter() - t0
            rec["thread_cpu_s"] = time.thread_time() - c0
            rec["gc_s"] = self.gc_clock.seconds - gc0
            return s, eng, res, host, pm

        s, eng, res, host, pm = timer(timed) if timer is not None else timed()
        rec.update(nattempts=res.nattempts, host_reads=res.host_reads, cg_steps=res.cg_steps,
                   chis=res.chis, path=eng.path, solver=eng.solver, band_m=eng.band_m,
                   edges=prob.num_edges)
        if pm is not None:
            rec["schur_s"] = pm.seconds()[prog.SCHUR_PHASE]
        if self.mix.kind == "fresh":
            rec["answer"] = prog.caller_order(s, host, prob.fixed_poses)
        else:
            rec["host_state"] = host
        del s, eng, res, host
        return rec

    def window(self, seconds: float) -> None:
        self.cpu_mhz = [cpu_mhz()]
        if self.device != "cpu":
            self.gpu_clocks = [gpu_clocks()]
        gc0 = self.gc_clock.snapshot()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.records.append(self.request(self.next_k, marks=self.trace))
            self.next_k += 1
        self.window_s = time.perf_counter() - t0
        self.gc_window = self.gc_clock.since(gc0)
        self.cpu_mhz.append(cpu_mhz())
        if self.device != "cpu":
            self.gpu_clocks.append(gpu_clocks())

    def trace_requests(self, host_too: bool = True) -> None:
        """Requests under the profiler, :data:`TRACE_REQUESTS` of them: the
        first with device activity only (busy time, device operations), the
        second, with ``host_too``, with the host's too (idle gaps by host
        activity).  Nothing where the run is on the CPU, which has no device
        trace."""
        from benchmark import trace

        if self.device == "cpu":
            return
        for host in (False, True)[:TRACE_REQUESTS if host_too else 1]:
            out = {}

            def timer(fn):
                result, out["t"] = trace.traced(fn, self.device, host=host)
                return result

            rec = self.request(self.next_k, timer=timer)
            self.next_k += 1
            if out["t"] is not None:
                key = "host" if host else "device"
                self.traced[key], self.traced_records[key] = out["t"], rec

    def release(self) -> None:
        """Frees the program's device state (the structure, host arrays
        only, stays for the answers' numbering)."""
        if hasattr(self, "engine"):
            del self.engine
        gc.collect()
        if self.device != "cpu":
            import torch

            torch.cuda.empty_cache()

    # -- what readers read ----------------------------------------------------

    def work(self):
        """The Schur complement phase's work per attempt (``work.py``), from
        the generated graph."""
        if self._work is None:
            import numpy as np

            from benchmark import work

            b = self.base
            self._work = work.schur_work(
                b.qs.shape[0], np.concatenate([b.mono_p, b.stereo_p]),
                np.concatenate([b.mono_l, b.stereo_l]), b.fixed_poses)
        return self._work

    # -- the check ------------------------------------------------------------

    def answers_to_check(self):
        """(problem, answers) groups, answers an iterable of (chis, qs, ts,
        Xws): every window answer of a solve mix (one problem), or
        :data:`CHECKED_FRESH` window answers of a fresh mix drawn from the
        seed, each with its own problem."""
        import numpy as np

        prog = self.program
        if self.mix.kind == "solve":
            fixed = self.base.fixed_poses
            out = ((r["chis"],) + prog.caller_order(self.structure, r["host_state"], fixed)
                   for r in self.records)
            return [(self.base, out)]
        rng = np.random.default_rng([self.seed, 0xC4EC])
        pick = rng.choice(len(self.records), min(CHECKED_FRESH, len(self.records)),
                          replace=False)
        groups = []
        for i in sorted(pick.tolist()):
            r = self.records[i]
            groups.append((self.problem(r["k"]), [(r["chis"],) + tuple(r["answer"])]))
        return groups

    def check(self, limits: dict):
        """(correct, the worst reading of each number)."""
        from benchmark import compare

        readings = []
        for prob, answers in self.answers_to_check():
            judge = compare.Judge(prob, self.cfg, self.device)
            readings += [judge.answer_numbers(*a) for a in answers]
            del judge
        if not readings:
            return False, {k: float("inf") for k in compare.NUMBERS}
        worst = compare.worst(readings)
        return compare.verdict(worst, limits), worst


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(args, device: str = "cuda", root: str = ROOT) -> dict:
    """Everything of a run after the card check: the result's object."""
    import torch

    from benchmark import compare
    from benchmark.traffic import Mix

    bench = load_bench(root)
    cell = find_cell(bench, args.workload)
    cfg = load_config(bench, cell["config"], root)
    mix = Mix.load(cell["traffic"], os.path.join(root, "benchmark"))
    limits = compare.load_limits(cell["name"], os.path.join(root, "benchmark"))
    readers = {m["name"]: load_reader(m["name"], os.path.join(root, "benchmark"))
               for m in cell_metrics(bench, cell["name"], bool(args.trace))}
    seed = args.seed % (1 << 64)

    run = Run(cell["name"], cfg, mix, seed, device, bool(args.trace))
    run.setup()
    run.setup_s = time.perf_counter() - T_START
    print(f"set-up {run.setup_s:.4f} s; libraries built before it: {run.built}; after it: "
          f"{run.program.libraries_built()}", file=sys.stderr)
    run.window(args.seconds)
    if device != "cpu":
        run.peak_bytes = torch.cuda.max_memory_allocated()
    if args.trace or any(getattr(r, "device_trace", False) for r in readers.values()):
        run.trace_requests(host_too=bool(args.trace))
    if args.trace:
        if "device" in run.traced:
            t = run.traced["device"]
            mean = sum(r["wall_s"] for r in run.records) / max(len(run.records), 1)
            print(f"traced request: wall {t.wall_s:.6f} s under the profiler "
                  f"(window mean {mean:.6f} s)")
    work = run.work() if args.trace else None
    metrics = {}
    for m in cell_metrics(bench, cell["name"], bool(args.trace)):
        value = readers[m["name"]](run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    run.release()
    t0 = time.perf_counter()
    correct, worst = run.check(limits)
    print(f"check: {time.perf_counter() - t0:.4f} s", file=sys.stderr)
    failed = sum(1 for r in run.records
                 if len(r["chis"]) == 0 or not all(map(lambda c: c == c, r["chis"])))
    result = {"correct": bool(correct), "attempted": len(run.records), "failed": failed,
              "metrics": metrics}
    if device != "cpu":
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                            "count": int(cell["chips"]), "memory_peak_bytes": run.peak_bytes}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}
    if args.trace and "device" in run.traced:
        t = run.traced["device"]
        result["device"].update(busy_s=t.busy_s, window_s=t.wall_s)
        gaps = run.traced["host"].idle_gaps() if "host" in run.traced else []
        result["breakdown"] = {"device_ops": [[n, s] for n, s in t.top_device_ops()],
                               "idle_gaps": [[n, s] for n, s in gaps]}
    result["run"] = {"seed": args.seed, "setup_s": run.setup_s, "window_s": run.window_s,
                     "libraries_built_before": run.built, "route": run.records[-1]["path"]
                     if run.records else None,
                     "solver": run.records[-1]["solver"] if run.records else None,
                     "band_m": run.records[-1]["band_m"] if run.records else None,
                     "edges": run.records[-1]["edges"] if run.records else None,
                     "work": None if work is None else vars(work),
                     "walls_s": [r["wall_s"] for r in run.records],
                     "gc_s": [r["gc_s"] for r in run.records],
                     "thread_cpu_s": [r["thread_cpu_s"] for r in run.records],
                     "gc_in_window": run.gc_window, "cpu_mhz": run.cpu_mhz,
                     "gpu_clocks": run.gpu_clocks}
    run.gc_clock.close()
    result["checks"] = {k: {"value": worst[k], "limit": limits[k]} for k in compare.NUMBERS}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    bench = load_bench()
    cell = find_cell(bench, args.workload)
    why = card_check(int(cell["chips"]))
    if why is not None:
        print(why, file=sys.stderr)
        return 2
    print(f"card: {power_limit()}", file=sys.stderr)
    result = execute(args)
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"modules of the JAX package or of JAX were imported: {bad}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
