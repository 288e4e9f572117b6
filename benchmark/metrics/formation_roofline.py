"""formation_roofline: the Schur complement phase's share of its roofline,
in percent: the least time of the phase's work (``work.py``, counted from
the generated graph) over its time per LM attempt, the port's
"4: Schur Complement" phase marks (CUDA events) summed over the window's
requests of a traced run and divided by their attempts."""

from benchmark import work


def read(run):
    recs = [r for r in run.records if "schur_s" in r]
    if run.mix.kind != "solve" or not recs:
        return None
    per_attempt = sum(r["schur_s"] for r in recs) / sum(r["nattempts"] for r in recs)
    return work.roofline_pct(run.work(), run.mix.dtype, per_attempt)
