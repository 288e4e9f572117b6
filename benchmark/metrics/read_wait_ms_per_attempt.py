"""read_wait_ms_per_attempt: the host's time blocked on the card an LM
attempt, in ms: the host time inside the ``cuba.read.*`` spans of the
port's ``cuba.optimize`` (each a device-to-host read that
``LMResult.host_reads`` counts), over the attempts, in the request that
``benchmark/spans.py`` profiles after the window."""

from benchmark import spans


def read(run):
    ps = spans.program_spans(run)
    if ps is None or not spans.host_us(ps.spans, "optimize"):
        return None
    return ps.per_attempt(spans.host_us(ps.spans, "read.", "optimize") / 1e3)
