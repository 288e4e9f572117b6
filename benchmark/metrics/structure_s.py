"""structure_s: the symbolic pass (step 1, ``build_structure_from_arrays``)
of the window's fresh requests, mean seconds a request.  The benchmark's
own host span."""


def read(run):
    spans = [r["structure_s"] for r in run.records if "structure_s" in r]
    return sum(spans) / len(spans) if spans else None
