"""upload_s: the host time of the engine's host-to-device copies in a fresh
request, in seconds: the port's ``cuba.engine.upload`` spans inside its
``cuba.engine`` span (the planner's tables, the segment sums' CSRs, the
state and the cameras), in the request that ``benchmark/spans.py``
profiles after the window."""

from benchmark import spans


def read(run):
    ps = spans.program_spans(run)
    if ps is None or not spans.host_us(ps.spans, "engine"):
        return None
    return spans.host_us(ps.spans, "engine.upload", "engine") / 1e6
