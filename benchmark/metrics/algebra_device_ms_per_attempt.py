"""algebra_device_ms_per_attempt: the device time of the per-attempt
algebra, in ms an LM attempt: the kernels launched inside the port's
``cuba.lm.error`` and ``cuba.lm.build`` spans (the residuals and the
per-edge Gauss-Newton terms with their sums), over the attempts, in the
request that ``benchmark/spans.py`` profiles after the window."""

from benchmark import spans


def read(run):
    ps = spans.program_spans(run)
    if ps is None or not spans.named(ps.spans, "lm.error"):
        return None
    us = spans.device_us(ps.spans, "lm.error") + spans.device_us(ps.spans, "lm.build")
    return ps.per_attempt(us / 1e3)
