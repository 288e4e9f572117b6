"""Where a request's device time goes, by the port's spans: one cell's
set-up, then one request under the profiler (``spans.program_spans``),
printed as tables a later change can aim by.

    python3 -m benchmark.span_table --workload <cell> --seed <n> [--top 12]

Printed: the device ms an LM attempt by innermost ``cuba.*`` span (a
kernel's innermost span is the one that launched it; "(no span)" is what
ran outside every span: the answer's copy to the host), each with its
share of the request's device time; the largest device operations by name,
each split by the innermost spans that launched it; the host ms an attempt
of each LM phase and read; and the CUDA runtime's calls that hold the host
longest, by innermost span (a synchronising call outside a ``read.*`` span
is a wait the host-read count misses).  The last line is a JSON object of
the same numbers.  On the card only.
"""

import argparse
import json
import os
import sys

from benchmark import run, spans


def tables(ps: spans.ProgramSpans, top: int = 12) -> dict:
    """The numbers :func:`main` prints, from one profiled request."""
    n = max(ps.attempts, 1)
    by_span, by_kernel = {}, {}
    for (span, kernel), us in ps.by_kernel.items():
        key = span or "(no span)"
        by_span[key] = by_span.get(key, 0.0) + us
        by_kernel.setdefault(kernel, {})
        by_kernel[kernel][key] = by_kernel[kernel].get(key, 0.0) + us
    total = sum(by_span.values()) or 1.0
    kernels = sorted(by_kernel.items(), key=lambda kv: -sum(kv[1].values()))[:top]
    host = {name: spans.host_us(ps.spans, name, "optimize") / 1e3 / n
            for name in sorted({s.name for s in ps.spans
                                if s.name.startswith(("lm.", "read."))})}
    calls = sorted(ps.host_calls.items(), key=lambda kv: -kv[1])[:top]
    return dict(
        attempts=ps.attempts, wall_s=ps.wall_s, device_ms=total / 1e3,
        by_span=[[k, v / 1e3 / n, 100 * v / total]
                 for k, v in sorted(by_span.items(), key=lambda kv: -kv[1])],
        kernels=[[k, sum(v.values()) / 1e3 / n,
                  {s: us / 1e3 / n for s, us in sorted(v.items(), key=lambda kv: -kv[1])}]
                 for k, v in kernels],
        host_ms=host,
        host_calls=[[span or "(no span)", call, us / 1e3 / n] for (span, call), us in calls])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    bench = run.load_bench()
    cell = run.find_cell(bench, args.workload)
    why = run.card_check(int(cell["chips"]))
    if why is not None:
        print(why, file=sys.stderr)
        return 2
    from benchmark.traffic import Mix

    cfg = run.load_config(bench, cell["config"])
    mix = Mix.load(cell["traffic"], os.path.join(run.ROOT, "benchmark"))
    r = run.Run(cell["name"], cfg, mix, args.seed % (1 << 64), "cuda", False)
    r.setup()
    ps = spans.program_spans(r)
    if ps is None:
        print("the profiled request holds no cuba.* span", file=sys.stderr)
        return 1
    t = tables(ps, args.top)
    print(f"{args.workload} seed {args.seed} on {run.power_limit()}: {t['attempts']} attempts, "
          f"device {t['device_ms']:.3f} ms, wall {t['wall_s']:.4f} s under the profiler")
    print("| innermost span | device ms / attempt | share |")
    for name, ms, pct in t["by_span"]:
        print(f"| `{name}` | {ms:.4f} | {pct:.1f}% |")
    print("| device operation | ms / attempt | launched under (ms / attempt) |")
    for name, ms, where in t["kernels"]:
        parts = ", ".join(f"`{s}` {v:.4f}" for s, v in where.items())
        print(f"| `{name[:60]}` | {ms:.4f} | {parts} |")
    print("host ms / attempt: " + ", ".join(f"{k} {v:.4f}" for k, v in t["host_ms"].items()))
    print("runtime calls, host ms / attempt: " + ", ".join(
        f"`{span}` {call} {ms:.4f}" for span, call, ms in t["host_calls"]))
    print(json.dumps(dict(workload=args.workload, seed=args.seed, **t)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
