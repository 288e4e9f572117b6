"""dense_device_ms_per_attempt: the device time of the dense reduced solve,
in ms an LM attempt: the kernels launched inside the port's ``cuba.dense``
span (equilibration, the factor and its boost retries, the diagonal
blocks' inverses, the sweeps and the refinement's matvecs), over the
attempts, in the request that ``benchmark/spans.py`` profiles after the
window.  Nothing where the program has no ``dense`` span."""

from benchmark import spans


def read(run):
    ps = spans.program_spans(run)
    if ps is None or not spans.named(ps.spans, "dense"):
        return None
    return ps.per_attempt(spans.device_us(ps.spans, "dense") / 1e3)
