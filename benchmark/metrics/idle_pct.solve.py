"""idle_pct.solve: the share of a solve request's wall in which no
operation ran on the device, in percent: 100 less the device's busy time
in one traced request (the union of its device intervals,
``torch.profiler``) over the mean wall of the window's requests, which ran
without the profiler.  Every request of a solve mix is the same problem, so
the device does the same work in each; the profiler slows the host, and
its traced wall would count that slowing as idle time."""


def read(run):
    t = run.traced.get("device")
    if run.mix.kind != "solve" or t is None or not run.records:
        return None
    wall = sum(r["wall_s"] for r in run.records) / len(run.records)
    return 100.0 * (1.0 - t.busy_s / wall)
