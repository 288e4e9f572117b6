"""lm_host_ms_per_attempt: the host's enqueue time an LM attempt, in ms:
the host time inside the port's ``cuba.optimize`` span less the time inside
its ``cuba.read.*`` spans (the host blocked on the card), over the
attempts, in the request that ``benchmark/spans.py`` profiles after the
window (host and device activity, so the host runs slower than unprofiled)."""

from benchmark import spans


def read(run):
    ps = spans.program_spans(run)
    if ps is None or not spans.host_us(ps.spans, "optimize"):
        return None
    own = spans.host_us(ps.spans, "optimize") - spans.host_us(ps.spans, "read.", "optimize")
    return ps.per_attempt(own / 1e3)
