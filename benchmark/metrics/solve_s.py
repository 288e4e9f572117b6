"""solve_s: the window's solve requests (steps 3-4: ``optimize`` from the
engine's initial state and the answer copied to the host), their walls
summed over their number.  Host clock, each wall ending when the host
holds the answer."""


def read(run):
    if run.mix.kind != "solve" or not run.records:
        return None
    return sum(r["wall_s"] for r in run.records) / len(run.records)
