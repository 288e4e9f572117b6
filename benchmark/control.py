"""The readings that a cell's limits are set from, at the cell's own size.

    python3 -m benchmark.control --workload <cell> --seeds S... --control-seeds S...

For each of ``--seeds``: the program solves the cell's problem of that
seed (the configuration's graph for a solve mix; the first window request
of a fresh mix) as a run does, and the three numbers of ``compare.py`` are
read against the float64 reference.  For each of ``--control-seeds``: the
control, the reference itself computed one precision below the mix's
(fp32 with TF32 products for a float32 mix, fp32 for a float64 mix), is
read the same way.  Prints one line a seed and, last, a JSON object with
every reading and, per number, the largest program reading and the
smallest control reading.  Runs on the card only, and fails without one as
``benchmark.run`` does.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from benchmark import compare, program, run, traffic

DEVICE = "cuda"


def problem_of(cfg, mix, seed):
    base = traffic.base_problem(cfg, seed)
    if mix.kind == "solve":
        return base
    return traffic.fresh_request(base, cfg, mix, seed, traffic.WARMUP_REQUESTS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    bench = run.load_bench()
    cell = run.find_cell(bench, args.workload)
    why = run.card_check(int(cell["chips"]))
    if why is not None:
        print(why, file=sys.stderr)
        return 2
    cfg = run.load_config(bench, cell["config"])
    mix = traffic.Mix.load(cell["traffic"])
    out = {"workload": cell["name"], "program": {}, "control": {}}
    for seed in args.seeds:
        t0 = time.perf_counter()
        prob = problem_of(cfg, mix, seed)
        s = program.structure(prob)
        eng = program.engine(s, cfg["huber_deltas"],
                             program.make_config(cfg, mix.dtype, DEVICE))
        res, host = program.solve(eng, cfg["iterations"])
        chis, facts = res.chis, dict(attempts=res.nattempts, iterations=res.niters,
                                     solver=eng.solver, path=eng.path, edges=prob.num_edges)
        answer = program.caller_order(s, host, prob.fixed_poses)
        del eng, res, host, s
        _free()
        judge = compare.Judge(prob, cfg, DEVICE)
        nums = judge.answer_numbers(chis, *answer)
        nums.update(facts, ref_iterations=len(judge.chis), seconds=time.perf_counter() - t0)
        out["program"][seed] = nums
        print(f"program seed {seed}: {json.dumps(nums)}", flush=True)
        del judge
        _free()
    lower = torch.float32
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        prob = problem_of(cfg, mix, seed)
        judge = compare.Judge(prob, cfg, DEVICE)
        ctl = compare.reference_of(prob, cfg, DEVICE, dtype=lower,
                                   tf32=mix.dtype == "float32")
        chis, (R, t, X) = ctl.optimize(cfg["iterations"])
        nums = judge.numbers(chis, R.double(), t.double(), X.double())
        nums.update(iterations=len(chis), ref_iterations=len(judge.chis),
                    seconds=time.perf_counter() - t0)
        out["control"][seed] = nums
        print(f"control seed {seed}: {json.dumps(nums)}", flush=True)
        del judge, ctl
        _free()
    out["lower"] = {k: max(v[k] for v in out["program"].values())
                    for k in compare.NUMBERS} if out["program"] else None
    out["upper"] = {k: min(v[k] for v in out["control"].values())
                    for k in compare.NUMBERS} if out["control"] else None
    print(json.dumps(out))
    return 0


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
