"""factors_per_attempt: the dense Cholesky factorisations an LM attempt
runs: the port's ``cuba.dense.cholesky`` spans (the first factor and each
fp32 boost retry, a whole new ``cholesky_ex``), over the attempts, in the
request that ``benchmark/spans.py`` profiles after the window.  1.0 where
no factor is retried.  Nothing where the program has no such span."""

from benchmark import spans


def read(run):
    ps = spans.program_spans(run)
    if ps is None:
        return None
    factors = len(spans.named(ps.spans, "dense.cholesky"))
    return ps.per_attempt(factors) if factors else None
