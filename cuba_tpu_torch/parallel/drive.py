"""Rank workers for :func:`parallel.launch.spawn`: the multi-device tests,
``samples/sample_multichip.py`` and ``chip_smoke.py`` drive the sharded LM
through them, so that a spawned rank imports only this package.

:func:`run_cases` runs a list of cases, the same on every rank, and
returns their results as arrays named ``"<case>.<key>"``.  A case is a
dict with ``name``, ``kind`` and:

- ``kind="engine"``: ``structure`` (a ``BAStructure``), ``kernels``,
  ``config`` (``BAConfig`` keywords, without ``device`` and ``mesh``) and
  ``iters``: ``MultiChipSolverAdapter.optimize`` from the structure's state;
  with ``aos=True`` on the AoS body (``MultiChipEngine``'s ``aos``).  With
  ``single=True`` (not with ``aos``) the single-device engine runs the same
  structure on the same device too (``single.*`` keys).
- ``kind="api"``: ``problem`` (``io.synthetic``'s problem), ``config``,
  ``iters`` and ``per_edge`` (read ``chi_squared`` of every edge, the
  default): ``BundleAdjustment`` with Huber kernels (as ``chip_smoke.py``
  sets them) and
  ``BAConfig(mesh=group)``; with ``profile_iters``, a second graph runs
  ``optimize(n, profile=True)``; with ``checkpoint=True``, the estimates
  go through ``save_checkpoint`` into a fresh graph, which runs on; with
  ``trace=True`` (on the card), a fresh graph's ``optimize`` runs under
  ``torch.profiler`` and the rank's device intervals come back
  (``trace_start``/``trace_end`` in µs, ``trace_wall`` in s).

``world=1`` runs a case on rank 0 alone, over a one-rank group of its
own.  Every case resets ``cudalib.LAUNCHES`` just before its run and reads
it just after, and reports the engine's :func:`route_facts`.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from cuba_tpu_torch.config import BAConfig
from cuba_tpu_torch.ops import cudalib

LAUNCH_NAMES = tuple(cudalib.LAUNCHES)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _np(t) -> np.ndarray:
    return t.detach().double().cpu().numpy()


def route_facts(eng) -> dict:
    """The route and solver of an engine, as the facts that decide which
    kernels its LM loop launches: the path and solver, and the pad, dtype
    and refinement steps of the dense solve."""
    return dict(solver=eng.solver, path=eng.path, band_m=eng.band_m,
                pad_blocks=eng.pad_blocks, dtype=str(eng.dtype).removeprefix("torch."),
                refine=eng.config.refinement_steps)


def _facts(eng) -> dict:
    return {k: np.array(v) for k, v in route_facts(eng).items()}


def _launches() -> dict:
    return dict(launches=np.array([cudalib.LAUNCHES[k] for k in LAUNCH_NAMES]),
                launches_f64=np.array([cudalib.LAUNCHES_F64[k] for k in LAUNCH_NAMES]))


def _result(r, device) -> dict:
    return dict(chis=np.asarray(r.chis, np.float64), qs=_np(r.state.qs), ts=_np(r.state.ts),
                Xws=_np(r.state.Xws), final_lambda=np.array(r.final_lambda),
                nattempts=np.array(r.nattempts), niters=np.array(r.niters))


def _engine_case(case, group, device) -> dict:
    from cuba_tpu_torch.parallel.sharding import MultiChipSolverAdapter
    from cuba_tpu_torch.solver.engine import BlockSolverEngine

    cfg = BAConfig(**case["config"], device=device)
    aos = case.get("aos", False)
    assert not (aos and case.get("single")), "the single-device engine plans its route"
    t0 = time.perf_counter()
    ad = MultiChipSolverAdapter(case["structure"], case["kernels"], cfg, group, aos)
    _sync(device)
    init_s = time.perf_counter() - t0
    cudalib.reset_launches()
    t0 = time.perf_counter()
    r = ad.optimize(None, case["iters"])
    _sync(device)
    out = dict(_result(r, device), **_launches(), **_facts(ad._mc),
               wall=np.array(time.perf_counter() - t0), init_wall=np.array(init_s),
               local_Xws=_np(ad._local.Xws), gathered=_np(ad.gathered_landmarks()))
    if case.get("single"):
        eng = BlockSolverEngine(case["structure"], case["kernels"], cfg)
        out.update({f"single.{k}": v for k, v in _result(eng.optimize(None, case["iters"]),
                                                           device).items()})
    return out


def _graph(case, cfg):
    from cuba_tpu_torch import EdgeType, RobustKernelType
    from cuba_tpu_torch.io import synthetic

    ba = synthetic.build_graph(case["problem"], cfg)
    ba.set_robust_kernels(RobustKernelType.HUBER, float(np.sqrt(5.991)), EdgeType.MONOCULAR)
    ba.set_robust_kernels(RobustKernelType.HUBER, float(np.sqrt(7.815)), EdgeType.STEREO)
    return ba


def _api_case(case, group, device) -> dict:
    cfg = BAConfig(**case["config"], device=device, mesh=group)
    ba = _graph(case, cfg)
    t0 = time.perf_counter()
    ba.initialize()
    _sync(device)
    init_s = time.perf_counter() - t0
    cudalib.reset_launches()
    t0 = time.perf_counter()
    ba.optimize(case["iters"])
    _sync(device)
    wall = time.perf_counter() - t0
    out = dict(_launches(), **_facts(ba._engine._mc), wall=np.array(wall),
               init_wall=np.array(init_s),
               chis=np.array([s.chi2 for s in ba.batch_statistics()]),
               final_lambda=np.array(ba.last_result.final_lambda),
               nattempts=np.array(ba.last_result.nattempts))
    pids, lids = sorted(ba._poses), sorted(ba._landmarks)
    out["pose_t"] = np.stack([ba.pose_vertex(i).t for i in pids])
    out["pose_q"] = np.stack([ba.pose_vertex(i).q for i in pids])
    out["lm_Xw"] = np.stack([ba.landmark_vertex(j).Xw for j in lids])
    if case.get("per_edge", True):
        out["chi_squared"] = np.array([ba.chi_squared(e) for e in list(ba._mono_edges)
                                       + list(ba._stereo_edges)])
    tp = ba.time_profile()
    keys = sorted(tp)
    out["profile_keys"] = np.array(keys)
    out["profile_values"] = np.array([tp[k] for k in keys])
    out["attributed"] = np.array(sorted(ba.attributed_phases()))
    if case.get("profile_iters"):
        pba = _graph(case, cfg)
        pba.initialize()
        pba.optimize(case["profile_iters"], profile=True)
        ptp = pba.time_profile()
        out["profiled_chis"] = np.array([s.chi2 for s in pba.batch_statistics()])
        out["profiled_values"] = np.array([ptp[k] for k in sorted(ptp)])
        out["profiled_keys"] = np.array(sorted(ptp))
    if case.get("trace"):
        out.update(_trace(case, cfg, device))
    if case.get("checkpoint"):
        import os
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "ckpt.npz")
            ba.save_checkpoint(path)
            rba = _graph(case, cfg)
            rba.load_checkpoint(path)
        out["restored_Xw"] = np.stack([rba.landmark_vertex(j).Xw for j in lids])
        out["restored_chis"] = np.array([s.chi2 for s in rba.batch_statistics()])
        rba.initialize()
        rba.optimize(2)
        out["resumed_chis"] = np.array([s.chi2 for s in rba.batch_statistics()])
    return out


def _trace(case, cfg, device) -> dict:
    """One more ``optimize`` of a fresh graph under ``torch.profiler``
    (device activity only): the device intervals it ran, up to a
    ``torch.cuda._sleep`` mark after it (an untimed run after the mark
    takes the events a session loses at its end), and its wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ba = _graph(case, cfg)
    ba.initialize()
    _sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ba.optimize(case["iters"])
        _sync(device)
        wall = time.perf_counter() - t0
        attempts = ba.last_result.nattempts
        torch.cuda._sleep(1)
        ba.optimize(case["iters"])
        _sync(device)
    events = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    marks = [i for i, ev in enumerate(events) if "spin_kernel" in ev[2]]
    events = events[:marks[0]] if marks else []
    return dict(trace_start=np.array([e[0] for e in events], np.float64),
                trace_end=np.array([e[1] for e in events], np.float64),
                trace_wall=np.array(wall), trace_attempts=np.array(attempts))


def run_cases(rank, group, device, cases) -> dict:
    """Every case of ``cases`` on this rank (see the module docstring).
    Asserts first that the rank runs without JAX."""
    import torch.distributed as dist

    assert not _foreign_modules(), f"a rank imported {_foreign_modules()}"
    solo = dist.new_group([0]) if any(c.get("world") == 1 for c in cases) else None
    out = {}
    for case in cases:
        g = group
        if case.get("world") == 1:
            if rank != 0:
                continue
            g = solo
        run = {"engine": _engine_case, "api": _api_case}[case["kind"]]
        out.update({f"{case['name']}.{k}": v for k, v in run(case, g, device).items()})
    out["modules"] = np.array(_foreign_modules())
    return out


def _foreign_modules() -> list:
    """The loaded modules of JAX and of the JAX package."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib") or (m + ".").startswith("cuba_tpu."))
