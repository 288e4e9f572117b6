#!/usr/bin/env python3
"""How much of a ``torch.profiler`` session's device trace survives, on one
NVIDIA GPU: the trace that ``chip_smoke.py`` splits with
``torch.cuda._sleep`` marks to count device operations.

    python3 cuba_tpu_torch/tools/probe_trace.py [--rounds 6]

On the kitti00 loop graph (``chip_smoke.KITTI``, fp32, ``solver="auto"``),
after a warm ``optimize(10)``, each round runs two profiler sessions of
plain ``optimize(10)`` calls, phase marks on and off
(``BAConfig.phase_attribution``):

- ``bare``: an untimed call, then a mark before each of the two calls and
  one after the last, then a synchronize; the line gives the device events
  the trace holds, the marks it holds (three were made) and the events
  between them;
- ``tailed``: ``chip_smoke.device_ops``, which runs one more untimed call
  after the last mark; the line gives its two counts.

Each line is one ``probe`` JSON object.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))


def emit(**kw):
    print("probe " + json.dumps(kw), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cuba_tpu_torch import BAConfig
    from cuba_tpu_torch.io import synthetic
    from cuba_tpu_torch.ops import segmm

    segmm.build_kernels()
    config = BAConfig(dtype=torch.float32, device="cuda")
    ba = smoke.make_graph(synthetic.generate(**smoke.KITTI), config)
    ba.initialize()
    ba.optimize(smoke.ITERS)
    torch.cuda.synchronize()
    modes = {"on": dataclasses.replace(config, phase_attribution=True),
             "off": dataclasses.replace(config, phase_attribution=False)}

    def plain_run(mode):
        ba.config = modes[mode]
        ba._state = ba._engine.state
        ba.optimize(smoke.ITERS)
        torch.cuda.synchronize()

    for r in range(args.rounds):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            plain_run("on")
            for mode in modes:
                torch.cuda._sleep(1)
                plain_run(mode)
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        names = [name for _start, name in sorted(
            (e.time_range.start, e.name) for e in prof.events()
            if e.device_type == DeviceType.CUDA)]
        marks = [i for i, name in enumerate(names) if "spin_kernel" in name]
        emit(round=r, session="bare", events=len(names), marks=len(marks),
             between=[b - a - 1 for a, b in zip(marks, marks[1:])], last=names[-1][:48])
        ba.time_profile()
        ops = smoke.device_ops({m: lambda m=m: plain_run(m) for m in modes}, torch)
        ba.time_profile()
        emit(round=r, session="tailed", ops={m: n for m, (n, _busy) in ops.items()})


if __name__ == "__main__":
    main()
