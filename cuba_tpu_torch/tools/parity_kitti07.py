"""kitti07-scale parity: the port's engine against its copy of the
independent NumPy/SciPy oracle (``reference/solver.py``) on the kitti07
graph (248 poses, 26,127 landmarks, ~95k edges; reference ba_kitti_07:
248 / 26,127 / 95,037).

    python -m cuba_tpu_torch.tools.parity_kitti07 [--device cuda|cpu]
        [--dtype float64|float32] [--poses 248] [--landmarks 26127]
        [--iters 10] [--out docs/PARITY_torch_kitti07.md]

Both sides run the same LM control law on the same internal-index
problem; the oracle assembles the full (6P+3L) sparse normal system and
solves it directly (no Schur complement, no padding).  In fp64 every
iteration's chi² must agree to 1e-6 relative and the final estimates to
RMSE q < 1e-8, t and Xw < 1e-7; in fp32 (the card's mode) every
iteration's chi² to 5e-3 (fp32's summation order over ~95k edges; the
estimates are logged).  The oracle is host work (~7 minutes at this size).

It writes (or replaces) this run's section, keyed by device and dtype, of
``--out`` and exits non-zero on failure.  On the card by default; without
one it fails (pass ``--device cpu`` for the host).
"""

import argparse
import os
import re
import sys
import time

import numpy as np
import torch

from cuba_tpu_torch.config import BAConfig
from cuba_tpu_torch.io import synthetic
from cuba_tpu_torch.reference.solver import RefProblem, ReferenceSolver
from cuba_tpu_torch.solver.engine import BlockSolverEngine
from cuba_tpu_torch.tools import graphs

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(REPO, "docs", "PARITY_torch_kitti07.md")
# per-iteration chi² and final-estimate gates by dtype
GATES = {"float64": dict(chi2=1e-6, q=1e-8, t=1e-7, Xw=1e-7),
         "float32": dict(chi2=5e-3, q=None, t=None, Xw=None)}
TITLE = "# kitti07-scale parity: cuba_tpu_torch's engine against its NumPy/SciPy oracle"


def run(params, device, dtype, iters):
    """(engine result dict, oracle result dict, comparison dict)."""
    prob = synthetic.generate(**params)
    s = graphs.structure_of(prob)
    nedges = prob.mono_p.size + prob.stereo_p.size
    config = BAConfig(dtype=getattr(torch, dtype), device=device)
    t0 = time.perf_counter()
    eng = BlockSolverEngine(s, graphs.KERNELS, config)
    r = eng.optimize(eng.state, iters)
    graphs.sync(device)
    t_eng = time.perf_counter() - t0
    chis_eng = np.asarray(r.chis, np.float64)
    t0 = time.perf_counter()
    ref = ReferenceSolver(RefProblem.from_structure(s, graphs.KERNELS))
    chis_ref = np.array(ref.optimize(iters), np.float64)
    t_ref = time.perf_counter() - t0
    n = min(chis_eng.size, chis_ref.size)
    rel = np.abs(chis_eng[:n] - chis_ref[:n]) / np.abs(chis_ref[:n])

    def rmse(a, b, k):
        a = a.double().cpu().numpy()[:k]
        return float(np.sqrt(np.mean((a - b[:k]) ** 2)))

    cmp = dict(n=n, rel=rel, q=rmse(r.state.qs, ref.p.qs, s.num_p),
               t=rmse(r.state.ts, ref.p.ts, s.num_p), Xw=rmse(r.state.Xws, ref.p.Xws, s.num_l))
    gate = GATES[dtype]
    cmp["ok"] = bool(n >= 5 and chis_eng.size == chis_ref.size and np.all(rel < gate["chi2"])
                     and all(gate[k] is None or cmp[k] < gate[k] for k in ("q", "t", "Xw")))
    return (dict(chis=chis_eng, wall=t_eng, solver=eng.solver, route=eng.path, niters=r.niters,
                 edges=int(nedges)),
            dict(chis=chis_ref, wall=t_ref), cmp)


def section(params, device, dtype, card, eng, ref, cmp):
    """This run's markdown section."""
    gate = GATES[dtype]
    est = ", ".join(f"{k} < {gate[k]:g}" for k in ("q", "t", "Xw") if gate[k] is not None)
    lines = [
        f"## {device} {dtype}",
        "",
        f"Generated by `python -m cuba_tpu_torch.tools.parity_kitti07 --device {device} "
        f"--dtype {dtype}` ({time.strftime('%Y-%m-%d')}; {card}).",
        "",
        f"Graph: {params['num_poses']} poses / {params['num_landmarks']} landmarks / "
        f"{eng['edges']} edges (seed {params['seed']}, mean_obs "
        f"{params['mean_obs_per_landmark']}, 25% stereo, Huber).",
        f"Engine: `BlockSolverEngine`, solver {eng['solver']} on route {eng['route']}, {dtype} "
        f"on {device}, {eng['niters']} iterations, {eng['wall']:.2f} s (construction + optimize, "
        f"first run of the process).",
        f"Oracle: `reference/solver.py` (scipy.sparse factorisation of the full (6P+3L) "
        f"system, fp64 on the host), {ref['chis'].size} iterations, {ref['wall']:.1f} s.",
        "",
        "| iter | engine chi2 | oracle chi2 | rel diff |",
        "|---|---|---|---|",
    ]
    for i in range(cmp["n"]):
        lines.append(f"| {i} | {eng['chis'][i]:.6f} | {ref['chis'][i]:.6f} | {cmp['rel'][i]:.2e} |")
    lines += [
        "",
        f"Final-estimate RMSE against the oracle: q {cmp['q']:.2e}, t {cmp['t']:.2e}, "
        f"Xw {cmp['Xw']:.2e}.",
        "",
        f"**Result: {'PASS' if cmp['ok'] else 'FAIL'}** (chi2 rel < {gate['chi2']:g} on every "
        f"iteration" + (f"; estimate RMSE {est}" if est else "; estimates logged, not gated")
        + ").",
        "",
    ]
    return "\n".join(lines)


def write_section(path, key, text):
    """Write ``text`` as the section headed ``## key`` of ``path``, keeping
    the file's other sections."""
    body = open(path).read() if os.path.exists(path) else ""
    parts = re.split(r"(?m)^(?=## )", body)
    head = parts[0] if parts and not parts[0].startswith("## ") else ""
    secs = [p for p in parts if p.startswith("## ")]
    secs = [p for p in secs if p.splitlines()[0] != f"## {key}"] + [text]
    if not head.strip():
        head = (f"{TITLE}\n\nEach section is one run of "
                "`cuba_tpu_torch/tools/parity_kitti07.py`, keyed by device and dtype.\n\n")
    with open(path, "w") as f:
        f.write(head + "\n".join(p.rstrip("\n") + "\n" for p in sorted(secs)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--poses", type=int, default=graphs.KITTI07["num_poses"])
    ap.add_argument("--landmarks", type=int, default=graphs.KITTI07["num_landmarks"])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=OUT)
    graphs.add_device_args(ap, dtype="float64")
    args = ap.parse_args(argv)
    params = dict(graphs.KITTI07, num_poses=args.poses, num_landmarks=args.landmarks)
    card = graphs.card(args.device)
    eng, ref, cmp = run(params, args.device, args.dtype, args.iters)
    text = section(params, args.device, args.dtype, card, eng, ref, cmp)
    write_section(args.out, f"{args.device} {args.dtype}", text)
    print(text, flush=True)
    return 0 if cmp["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
