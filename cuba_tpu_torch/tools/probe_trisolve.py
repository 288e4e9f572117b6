#!/usr/bin/env python3
"""The four kernels of ``csrc/trisolve.cu`` beside the one torch call
computing each, warm and cold, on one NVIDIA GPU.

    python3 cuba_tpu_torch/tools/probe_trisolve.py [--root DIR] [--sizes N ...] [--kernels K ...]

``cuba_tpu_torch`` is imported from DIR (default: the checkout this script
lies in), so that two trees can be measured in one call, one process each;
the timing helpers and the bound come from this checkout's
``chip_smoke.py`` and ``tools/roofline.py`` (``tools/smoke_loader.py``:
one yardstick for both trees).  At n = 1536 (kitti07's dense system), 3072
and 8448 (the kitti00 loop graph built ``dense_cholesky``), or the
``--sizes`` given, on a seeded SPD matrix A and its Cholesky factor L, it
prints one ``probe`` JSON line per kernel (or the ``--kernels`` given), n
and cache regime (``chip_smoke.interleaved_times``: ``warm``, each call
after an untimed run of itself; ``cold``, after a 128 MB read): the device
and event-timed call time of the wrapper and of its torch call
(``torch.mv``, the strided diagonal copy, ``solve_triangular``), of the
sweeps' plain versions (``plain``), and the kernel's bound
(``roofline.bound``); where DIR has them
(``trisolve.solve_lower_launch``), the sweeps' launches.  Where DIR holds
the sliced matvec (``trisolve.matvec_slices``), the matvec line also times
the kernel at every S (``S4``: slices a row), with the S the wrapper's
rule picks (``rule``) and the fastest (``best``).
"""

import argparse
import json
import os
import sys

import smoke_loader  # this checkout's, from the script's directory

SIZES = (1536, 3072, 8448)
KERNELS = ("matvec", "extract_diag_blocks", "solve_lower", "solve_upper")


def emit(**kw):
    print("probe " + json.dumps(kw), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=smoke_loader.REPO)
    ap.add_argument("--sizes", nargs="+", type=int, default=list(SIZES))
    ap.add_argument("--kernels", nargs="+", default=list(KERNELS), choices=KERNELS)
    args = ap.parse_args()
    smoke = smoke_loader.load_smoke(args.root)

    import torch

    if not torch.cuda.is_available():
        sys.exit("probe_trisolve: needs a CUDA device")
    from cuba_tpu_torch.ops import cudalib
    from cuba_tpu_torch.solver import trisolve

    tree = os.path.abspath(args.root)
    cudalib.build_kernels(["trisolve"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sweep = hasattr(trisolve, "matvec_slices")
    B = trisolve.BLOCK

    def report(kernel, n, fns, work, rule_key=None, launch=None):
        if kernel not in args.kernels:
            return
        for cold in (False, True):
            times = smoke.interleaved_times(fns, torch, cold=cold)
            points = {k: dms for k, (_ms, dms) in times.items() if k[0] == "S" and k[1:].isdigit()}
            best = min(points, key=points.get) if points else None
            emit(tree=tree, kernel=kernel, n=n, cache="cold" if cold else "warm",
                 bound_ms=smoke.roofline.bound(*work)[0], launch=launch, rule=rule_key,
                 rule_device_ms=points.get(rule_key), best=best,
                 best_device_ms=points.get(best),
                 times={k: {"ms": ms, "device_ms": dms} for k, (ms, dms) in times.items()})

    for n in args.sizes:
        M = torch.randn((n, n), generator=gen, device=dev)
        A = M @ M.T / n + torch.eye(n, device=dev)
        del M
        L = torch.linalg.cholesky(A).contiguous()  # row-major, as dense_cholesky.factor gives it
        x = torch.randn(n, generator=gen, device=dev)
        K = n // B
        invd = trisolve.prepare(L)
        y = trisolve.solve_lower(L, invd, x)
        # L's strictly-lower blocks (invd stands for the diagonal ones), invd, in and out
        tri_bytes = 4 * ((n * n - K * B * B) // 2 + K * B * B + 2 * n)

        fns, rule_key = {"wrapper": lambda: trisolve.matvec(A, x)}, None
        if sweep:
            rule_key = f"S{trisolve.matvec_slices(n)}"
            for S in (1, 2, 4, 8):
                fns[f"S{S}"] = lambda S=S: trisolve._matvec_kernel(A, x, S)
        fns["torch.mv"] = lambda: torch.mv(A, x)
        report("matvec", n, fns, (4 * (n * n + 2 * n), 2 * n * n), rule_key)

        report("extract_diag_blocks", n, {
            "wrapper": lambda: trisolve.extract_diag_blocks(L),
            "diagonal copy": lambda: torch.diagonal(
                L.reshape(K, B, K, B), dim1=0, dim2=2).permute(2, 0, 1).contiguous()},
            (8 * K * B * B, 0))
        report("solve_lower", n, {
            "wrapper": lambda: trisolve.solve_lower(L, invd, x),
            "plain": lambda: trisolve.solve_lower_plain(L, invd, x),
            "solve_triangular": lambda: torch.linalg.solve_triangular(
                L, x[:, None], upper=False)}, (tri_bytes, n * n),
            launch=getattr(trisolve, "solve_lower_launch", lambda n: None)(n))
        report("solve_upper", n, {
            "wrapper": lambda: trisolve.solve_upper(L, invd, y),
            "plain": lambda: trisolve.solve_upper_plain(L, invd, y),
            "solve_triangular": lambda: torch.linalg.solve_triangular(
                L.mT, y[:, None], upper=True)}, (tri_bytes, n * n),
            launch=trisolve.solve_upper_launch(n))
        del A, L, x, invd, y


if __name__ == "__main__":
    main()
