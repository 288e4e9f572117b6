"""host_reads_per_solve: the LM loop's device-to-host reads per
``optimize`` (``LMResult.host_reads``), mean over the window's requests."""


def read(run):
    if run.mix.kind != "solve" or not run.records:
        return None
    return sum(r["host_reads"] for r in run.records) / len(run.records)
