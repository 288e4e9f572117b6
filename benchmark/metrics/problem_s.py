"""problem_s: the window's fresh requests (steps 1-4: the symbolic pass,
the engine's planner and upload, ``optimize`` and the answer copied to the
host), their walls summed over their number.  Host clock."""


def read(run):
    if run.mix.kind != "fresh" or not run.records:
        return None
    return sum(r["wall_s"] for r in run.records) / len(run.records)
