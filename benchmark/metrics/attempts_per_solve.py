"""attempts_per_solve: the LM loop's damped attempts per ``optimize``
(``LMResult.nattempts``), mean over the window's requests."""


def read(run):
    if run.mix.kind != "solve" or not run.records:
        return None
    return sum(r["nattempts"] for r in run.records) / len(run.records)
