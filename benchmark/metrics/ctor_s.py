"""ctor_s: the planner and the upload (step 2, ``BlockSolverEngine``) of
the window's fresh requests, mean seconds a request.  The benchmark's own
host span, ending in a synchronize."""


def read(run):
    spans = [r["ctor_s"] for r in run.records if "ctor_s" in r]
    return sum(spans) / len(spans) if spans else None
