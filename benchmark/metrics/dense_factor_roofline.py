"""dense_factor_roofline: the dense factor's share of its roofline, in
percent: one factorisation's least time (``dense_work.factor_work`` of n,
the reduced system's rows) over the device time of the kernels launched
inside the port's ``cuba.dense.factor`` span an LM attempt (the factor,
its boost decision and any retries), in the request that
``benchmark/spans.py`` profiles after the window.  Nothing where the
program has no ``dense`` span."""

from benchmark import dense_work, spans


def read(run):
    ps = spans.program_spans(run)
    eng = getattr(run, "engine", None)
    if ps is None or eng is None or not spans.named(ps.spans, "dense"):
        return None
    per_attempt = ps.per_attempt(spans.device_us(ps.spans, "dense.factor") * 1e-6)
    if not per_attempt:
        return None
    least = dense_work.least_seconds(dense_work.factor_work(6 * eng.plan.pad_blocks))
    return 100.0 * least / per_attempt
