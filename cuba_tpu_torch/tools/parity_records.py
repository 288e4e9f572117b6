"""The fp64 records of the port's parity tools, and the tool over the
graphs that ``parity_kitti00`` does not cover: stress-1m, Ladybug-49 BAL
and pcg4096, against ``cuba_tpu``'s own fp64 records of the same graphs.

    [OMP_NUM_THREADS=N] python -m cuba_tpu_torch.tools.parity_records --phase fp64
        --device cpu [--entries stress_1m ladybug49_bal pcg4096]
    python -m cuba_tpu_torch.tools.parity_records --phase compare

The entries (ENTRIES), each ``optimize(10)`` in fp64:

- ``stress_1m``: ``graphs.STRESS`` (1778 P, 1,000,000 L, 3,885,457 E),
  the Huber kernels, ``solver="auto"`` (``band_cr``, m = 28);
- ``ladybug49_bal``: ``data/bal_ladybug_scale.txt.gz`` through
  ``io.bal.read_bal`` with no robust kernel and the ``BAConfig`` defaults
  apart from dtype and device (``dense_cholesky``, n = 768);
- ``pcg4096``: ``graphs.PCG4096`` (4096 P, 61,440 L, 238,292 E), the Huber
  kernels, ``solver="pcg"``.

``--phase fp64`` runs the port's engine and writes its chi² per iteration,
keyed by entry and device, into ``docs/_parity_torch_stress_bal_pcg_fp64.json``
(with the torch thread count it ran with).  The committed record is the
host's (``--device cpu``): the plain versions only, independent of every
hand-written kernel.  stress-1m takes minutes and tens of GB of host
memory; without a card the default device fails.

``--phase compare`` writes ``docs/PARITY_torch_stress_bal_pcg.md``: per
iteration, the port's host record against ``cuba_tpu``'s
(``docs/_parity_torch_cuba_fp64.json``, written by
``tests/test_torch_records.py --write``, read only here).  It exits 1
unless both records hold every entry with the same edges and every
iteration agrees to RTOL.

What both parity tools share lives here: reading and writing a record
(``load``, ``write_record``), the fp64 run of a generator's graph
(``run_synthetic``), the per-iteration comparison (``rel_diff``,
``compare``) and the markdown (``section``, ``document``).
``chip_smoke.py`` gates the card's runs of these graphs on ``cuba_tpu``'s
record through :func:`reference`.
"""

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

from cuba_tpu_torch.tools import graphs

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CUBA_RECORD = os.path.join(REPO, "docs", "_parity_torch_cuba_fp64.json")  # read only
KITTI_RECORD = os.path.join(REPO, "docs", "_parity_kitti00_fp64.json")  # read only
RECORD = os.path.join(REPO, "docs", "_parity_torch_stress_bal_pcg_fp64.json")
OUT = os.path.join(REPO, "docs", "PARITY_torch_stress_bal_pcg.md")
NITERS = 10
# two fp64 runs of one graph agree to this share of chi² at every iteration
RTOL = 1e-9
ENTRIES = {
    "stress_1m": dict(kind="synthetic", params=graphs.STRESS, solver="auto"),
    "ladybug49_bal": dict(kind="bal", file="data/bal_ladybug_scale.txt.gz", solver="auto"),
    "pcg4096": dict(kind="synthetic", params=graphs.PCG4096, solver="pcg"),
}
TITLE = ("# Parity of stress-1m, Ladybug-49 BAL and pcg4096: the port's fp64 against the "
         "fp64 records of cuba_tpu")
NOTES = ("`cuba_tpu`'s record is its XLA engine in fp64 (JAX x64) on the CPU,",
         "`docs/_parity_torch_cuba_fp64.json`, written by",
         "`JAX_PLATFORMS=cpu python tests/test_torch_records.py --write`.",
         "The port's is its own engine in fp64 on the host (`--phase fp64 --device cpu`):",
         "the plain torch versions of every kernel, independent of the hand-written CUDA",
         "(`docs/_parity_torch_stress_bal_pcg_fp64.json`).")


def load(path: str) -> dict:
    """A record file's entries (none where the file is missing)."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def write_record(path: str, entry: dict, *keys) -> None:
    """Store ``entry`` under ``keys`` (nested) in the record file at
    ``path``, its other entries kept."""
    record = load(path)
    node = record
    for key in keys[:-1]:
        node = node.setdefault(key, {})
    node[keys[-1]] = entry
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")


def band_m_of(engine):
    """The engine's CR block count where it solves a band, else None."""
    return int(engine.band_m) if engine.solver in ("band_cr", "band_lr") else None


def rel_diff(chis, ref):
    """The per-iteration relative difference over the common iterations."""
    ref = np.asarray(ref, np.float64)
    n = min(len(chis), len(ref))
    return np.abs(np.asarray(chis[:n], np.float64) - ref[:n]) / np.abs(ref[:n])


def compare(chis, refs: dict, gate: float):
    """({name: per-iteration relative difference}, ok) of a trajectory
    against each reference trajectory: ok where every reference has as
    many iterations, at least 5, and every one is within ``gate``."""
    rels, ok = {}, True
    for name, ref in refs.items():
        rels[name] = rel_diff(chis, ref)
        n = len(rels[name])
        ok = ok and n == len(chis) == len(ref) and n >= 5 and bool(np.all(rels[name] < gate))
    return rels, ok


def section(key: str, nedges: int, facts: str, chis, refs: dict, rels: dict, ok: bool,
            gate: float, what: str = "fp32", digits: bool = False) -> str:
    """One graph's markdown section: ``facts`` (a line on the runs), then
    the per-iteration table of the ``what`` run against every reference
    (chi² to two decimals, or with ``digits`` every digit)."""
    def num(x):
        return repr(float(x)) if digits else f"{x:.2f}"

    names = list(refs)
    lines = [f"## {key} ({nedges} edges, {len(chis)} LM iterations)", "", facts, "",
             f"| iter | {what} chi2 | " + " | ".join(f"{n} | rel diff" for n in names) + " |",
             "|---|---|" + "---|---|" * len(names)]
    for i in range(len(chis)):
        cells = " | ".join(f"{num(refs[n][i])} | {rels[n][i]:.2e}" if i < len(rels[n])
                           else "– | –" for n in names)
        lines.append(f"| {i} | {num(chis[i])} | {cells} |")
    worst = max(float(r.max()) for r in rels.values())
    lines += ["", f"max rel diff {worst:.2e} — {'PASS' if ok else 'FAIL'} (< {gate:g} at "
              "every iteration, against every reference)", ""]
    return "\n".join(lines)


def document(title: str, how: str, notes, sections, ok: bool) -> str:
    """The whole markdown file: title, how it was made, ``notes`` (lines
    on the records), the sections and the overall result."""
    return "\n".join([title, "", how, "", *notes, "", *sections,
                      f"**Overall: {'PASS' if ok else 'FAIL'}**", ""])


def run_synthetic(params: dict, dtype, device, solver: str = "auto") -> dict:
    """The engine's optimize(NITERS) on the generator's graph with the
    Huber kernels: chis, nedges, solver, band_m, route and wall
    (construction included)."""
    from cuba_tpu_torch.config import BAConfig
    from cuba_tpu_torch.io import synthetic
    from cuba_tpu_torch.solver.engine import BlockSolverEngine

    prob = synthetic.generate(**params)
    nedges = int(prob.mono_p.size + prob.stereo_p.size)
    t0 = time.perf_counter()
    eng = BlockSolverEngine(graphs.structure_of(prob), graphs.KERNELS,
                            BAConfig(dtype=dtype, device=device, solver=solver))
    del prob
    r = eng.optimize(eng.state, NITERS)
    graphs.sync(device)
    return dict(chis=np.asarray(r.chis, np.float64), nedges=nedges, solver=eng.solver,
                band_m=band_m_of(eng), route=eng.path, wall=time.perf_counter() - t0)


def bal_path(spec) -> str:
    return os.path.join(REPO, spec["file"])


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def params_of(spec) -> dict:
    """The parameters a record of the entry carries: the generator's
    arguments, or the BAL file and its reading (no robust kernel)."""
    if spec["kind"] == "bal":
        return dict(file=spec["file"], robust_kernel=None, solver=spec["solver"])
    return dict(spec["params"], solver=spec["solver"])


def reference(name: str, nedges: int, record_path: str = None):
    """``cuba_tpu``'s recorded chi² per iteration of entry ``name``, after
    checking that the record exists and was made from the graph this
    checkout builds: the same parameters, ``nedges`` and, for a BAL file,
    the file's sha256.  Raises ValueError otherwise."""
    spec = ENTRIES[name]
    record_path = record_path or CUBA_RECORD
    rec = load(record_path).get(name)
    if rec is None:
        raise ValueError(f"{record_path} holds no {name!r} entry")
    want = params_of(spec)
    if rec.get("params") != want:
        raise ValueError(f"{name}: the record's parameters {rec.get('params')} are not "
                         f"this checkout's {want}")
    if rec.get("nedges") != nedges:
        raise ValueError(f"{name}: the record has {rec.get('nedges')} edges, the graph "
                         f"{nedges}")
    if spec["kind"] == "bal" and rec.get("sha256") != sha256(bal_path(spec)):
        raise ValueError(f"{name}: the record's sha256 is not {spec['file']}'s")
    if len(rec.get("chis", ())) != rec.get("niters") or rec.get("niters") != NITERS:
        raise ValueError(f"{name}: the record has {len(rec.get('chis', ()))} of "
                         f"{NITERS} iterations")
    return np.asarray(rec["chis"], np.float64)


def run(name: str, dtype, device) -> dict:
    """The port's ``optimize(NITERS)`` of entry ``name``: chis, nedges,
    solver, band_m, route and wall (construction included)."""
    spec = ENTRIES[name]
    if spec["kind"] == "synthetic":
        return run_synthetic(spec["params"], dtype, device, spec["solver"])
    from cuba_tpu_torch.config import BAConfig
    from cuba_tpu_torch.io import bal

    t0 = time.perf_counter()
    ba = bal.read_bal(bal_path(spec), BAConfig(dtype=dtype, device=device,
                                               solver=spec["solver"]))
    ba.initialize()
    ba.optimize(NITERS)
    graphs.sync(device)
    eng = ba._engine
    return dict(chis=np.array([s.chi2 for s in ba.batch_statistics()], np.float64),
                nedges=int(ba.nedges()), solver=eng.solver, band_m=band_m_of(eng),
                route=eng.path, wall=time.perf_counter() - t0)


def fp64_phase(args, card: str) -> int:
    for name in args.entries:
        r = run(name, torch.float64, args.device)
        write_record(RECORD, dict(
            chis=r["chis"].tolist(), nedges=r["nedges"], solver=r["solver"],
            band_m=r["band_m"], route=r["route"], card=card, threads=torch.get_num_threads(),
            wall_s=round(r["wall"], 1), date=time.strftime("%Y-%m-%d"), niters=NITERS),
            name, args.device)
        print(f"# {name}: fp64 {len(r['chis'])} iters on {args.device} "
              f"({torch.get_num_threads()} threads) in {r['wall']:.1f} s, {r['solver']} on "
              f"{r['route']}, final chi2 {float(r['chis'][-1])!r}", flush=True)
    return 0


def compare_phase(args) -> int:
    mine, cuba = load(RECORD), load(CUBA_RECORD)
    sections, ok = [], True
    for name in args.entries:
        port = mine.get(name, {}).get("cpu")
        if port is None or name not in cuba:
            print(f"no record of {name}: run --phase fp64 --device cpu ({RECORD}) and "
                  f"tests/test_torch_records.py --write ({CUBA_RECORD})", file=sys.stderr)
            return 2
        c = cuba[name]
        refs = {"cuba_tpu fp64": reference(name, port["nedges"])}
        rels, entry_ok = compare(port["chis"], refs, RTOL)
        ok = ok and entry_ok
        facts = (f"`cuba_tpu`: {c['solver']}" + (f" (m = {c['band_m']})" if c["band_m"] else "")
                 + f", {c['backend']} backend, jax {c['jax']}, {c['host']}, {c['wall_s']} s "
                 f"({c['date']}).  The port: {port['solver']} on {port['route']}, host, "
                 f"{port['threads']} threads, {port['wall_s']} s ({port['date']}).")
        sections.append(section(name, c["nedges"], facts, port["chis"], refs, rels, entry_ok,
                                RTOL, "port fp64 (host)", digits=True))
        print(f"# {name}: max rel {rels['cuba_tpu fp64'].max():.2e} "
              f"{'PASS' if entry_ok else 'FAIL'}", flush=True)
    how = (f"Generated by `python -m cuba_tpu_torch.tools.parity_records --phase compare` "
           f"({time.strftime('%Y-%m-%d')}).")
    with open(OUT, "w") as f:
        f.write(document(TITLE, how, NOTES, sections, ok))
    print(f"wrote {OUT}: {'PASS' if ok else 'FAIL'}", flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", choices=("fp64", "compare"), required=True)
    ap.add_argument("--entries", nargs="*", default=list(ENTRIES), choices=list(ENTRIES))
    graphs.add_device_args(ap, dtype=None)
    args = ap.parse_args(argv)
    if args.phase == "compare":
        return compare_phase(args)
    return fp64_phase(args, graphs.card(args.device))


if __name__ == "__main__":
    sys.exit(main())
