"""solve_device_s: the card's busy time in one solve request, in seconds:
the union of the device intervals of a request run under
``torch.profiler`` (device activity only) after the window, which a run
makes with ``--trace 0`` too.  Every request of a solve mix is the same
problem from the same initial state, so the device does the same work in
each.  This is the card time a solve takes from other work that shares the
card, and the least its wall can come down to once the host no longer
holds it back.  Where the host holds the wall back, its walls spread too
widely for a bound, and ``solve_wall_s`` reports them per layer."""


def read(run):
    t = run.traced.get("device")
    if run.mix.kind != "solve" or t is None:
        return None
    return t.busy_s


read.device_trace = True
