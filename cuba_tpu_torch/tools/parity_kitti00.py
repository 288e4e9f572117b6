"""Headline-scale parity: the fp32 configuration on the card against fp64
records, per LM iteration, on bench.py's three default graphs.

    python -m cuba_tpu_torch.tools.parity_kitti00 --phase fp64 --device cpu
    python -m cuba_tpu_torch.tools.parity_kitti00 --phase fp32
        [--shapes kitti00_scale_loop kitti00_scale kitti07_scale]
        [--poses P] [--landmarks L] [--device cuda|cpu]

The shapes are bench.py's: ``kitti00_scale_loop`` (1322 P, 133,383 L,
loop closure; ``band_cr``), ``kitti00_scale`` (the same without it) and
``kitti07_scale`` (248 P, 26,127 L; ``dense_cholesky``), seed 0, Huber,
``solver="auto"``, 10 iterations (``--poses`` / ``--landmarks`` resize
every shape; a resized shape is recorded under its own key).

``--phase fp64`` runs the port's engine in fp64 and writes its chi² per
iteration, keyed by shape and device, into
``docs/_parity_torch_kitti00_fp64.json``, then prints the
``CHI2_FP64_FINAL`` entries.  The committed record is the host's
(``--device cpu``): the plain versions only, independent of every
hand-written kernel.  It takes host minutes at full size.

``--phase fp32`` runs the fp32 configuration (on the card by default) and
writes ``docs/PARITY_torch_kitti00.md``: per iteration, its chi² against
the port's host fp64 record and against ``cuba_tpu``'s fp64 record
(``docs/_parity_kitti00_fp64.json``, read only).  It exits 1 unless every
iteration is within 5e-3 of both.  Without a card the default fails (pass
``--device cpu`` for the host).  Reading and writing the records, the
runs, the comparison and the tables are ``parity_records``'s.
"""

import argparse
import os
import sys
import time

import torch

from cuba_tpu_torch.tools import graphs, parity_records
from cuba_tpu_torch.tools.parity_records import load, run_synthetic, section, write_record

RECORD = os.path.join(parity_records.REPO, "docs", "_parity_torch_kitti00_fp64.json")
TPU_RECORD = parity_records.KITTI_RECORD  # read only
OUT = os.path.join(parity_records.REPO, "docs", "PARITY_torch_kitti00.md")
# bench.py's shapes and their generator arguments in graphs.GRAPHS
SHAPES = {"kitti00_scale_loop": "kitti00-loop", "kitti00_scale": "kitti00",
          "kitti07_scale": "kitti07"}
NITERS = parity_records.NITERS
GATE = 5e-3
TITLE = "# kitti00-scale parity: cuba_tpu_torch's fp32 on the card against fp64 records"


def params_of(shape: str, args) -> dict:
    return graphs.graph_params(SHAPES[shape], args)


def key_of(shape: str, params: dict) -> str:
    """The record's key: the shape's name, with its size where resized."""
    if params == graphs.GRAPHS[SHAPES[shape]]:
        return shape
    return f"{shape} ({params['num_poses']} P / {params['num_landmarks']} L)"


def compare(chis, refs: dict):
    """``parity_records.compare`` at GATE: ok where every reference has as
    many iterations, at least 5, and every one is within GATE."""
    return parity_records.compare(chis, refs, GATE)


def document(sections, ok: bool, how: str) -> str:
    """The whole markdown file: title, how it was made, the sections and
    the overall result."""
    return parity_records.document(TITLE, how, (
        "The port's fp64 record is its own engine in fp64 on the host: the plain",
        "torch versions of every kernel, independent of the hand-written CUDA.",
        "`cuba_tpu`'s record is its XLA engine in fp64 on the CPU",
        "(`docs/_parity_kitti00_fp64.json`, read only)."), sections, ok)


def fp64_phase(args, card: str) -> int:
    for shape in args.shapes:
        params = params_of(shape, args)
        key = key_of(shape, params)
        r = run_synthetic(params, torch.float64, args.device)
        write_record(RECORD, dict(
            chis=r["chis"].tolist(), nedges=r["nedges"], solver=r["solver"], route=r["route"],
            card=card, date=time.strftime("%Y-%m-%d"), niters=NITERS), key, args.device)
        print(f"# {key}: fp64 {len(r['chis'])} iters on {args.device} in {r['wall']:.1f} s, "
              f"final chi2 {r['chis'][-1]:.2f}", flush=True)
    print("\n# CHI2_FP64_FINAL entries:")
    for key, by_device in load(RECORD).items():
        for device, rec in by_device.items():
            print(f'    ("{key}", {rec["niters"]}): {rec["chis"][-1]:.2f},  # {device}')
    return 0


def fp32_phase(args, card: str) -> int:
    record, tpu = load(RECORD), load(TPU_RECORD)
    sections, ok = [], True
    for shape in args.shapes:
        params = params_of(shape, args)
        key = key_of(shape, params)
        if "cpu" not in record.get(key, {}) or key not in tpu:
            print(f"no fp64 record of {key}: run --phase fp64 --device cpu first "
                  f"({RECORD}; cuba_tpu's: {TPU_RECORD})", file=sys.stderr)
            return 2
        rec = record[key]["cpu"]
        r = run_synthetic(params, torch.float32, args.device)
        refs = {"port fp64 (host)": rec["chis"], "cuba_tpu fp64": tpu[key]["chis"]}
        rels, shape_ok = compare(r["chis"], refs)
        ok = ok and shape_ok
        facts = (f"fp32: solver {r['solver']} on route {r['route']}, {args.device} ({card}), "
                 f"{r['wall']:.1f} s with construction; port fp64: {rec['solver']} on "
                 f"{rec['route']}, host ({rec['date']}); cuba_tpu fp64: {tpu[key]['solver']} "
                 f"on {tpu[key]['backend']} ({tpu[key]['date']}).")
        sections.append(section(key, r["nedges"], facts, r["chis"], refs, rels, shape_ok, GATE))
        print(f"# {key}: max rel " + ", ".join(f"{n} {v.max():.2e}" for n, v in rels.items())
              + f" {'PASS' if shape_ok else 'FAIL'}", flush=True)
    how = (f"Generated by `python -m cuba_tpu_torch.tools.parity_kitti00 --phase fp32` "
           f"({time.strftime('%Y-%m-%d')}; {card}).")
    with open(OUT, "w") as f:
        f.write(document(sections, ok, how))
    print(f"wrote {OUT}: {'PASS' if ok else 'FAIL'}", flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", choices=("fp64", "fp32"), required=True)
    ap.add_argument("--shapes", nargs="*", default=list(SHAPES), choices=list(SHAPES))
    graphs.add_size_args(ap)
    graphs.add_device_args(ap, dtype=None)
    args = ap.parse_args(argv)
    card = graphs.card(args.device)
    return (fp64_phase if args.phase == "fp64" else fp32_phase)(args, card)


if __name__ == "__main__":
    sys.exit(main())
