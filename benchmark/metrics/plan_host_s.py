"""plan_host_s: the planner's host time in a fresh request, in seconds: the
host time inside the port's ``cuba.engine`` span (solver resolution, the
row plan, ``schur_lane_csr``, the band tables) less the time inside its
``cuba.engine.upload`` spans, in the request that ``benchmark/spans.py``
profiles after the window."""

from benchmark import spans


def read(run):
    ps = spans.program_spans(run)
    if ps is None or not spans.host_us(ps.spans, "engine"):
        return None
    own = spans.host_us(ps.spans, "engine") - spans.host_us(ps.spans, "engine.upload", "engine")
    return own / 1e6
