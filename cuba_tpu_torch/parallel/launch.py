"""Start the ranks of a landmark-sharded run: one process each, under the
``spawn`` start method of ``torch.multiprocessing``.

:func:`spawn` runs ``fn(rank, group, device, *args)`` on every rank.  The
ranks join one process group through a file in a temporary directory (no
TCP port, so that concurrent runs never collide), each with ``timeout`` as
its collectives' limit, and ``fn`` returns a dict of arrays, which comes
back as the rank's ``.npz`` file.  The parent checks every rank's exit
code and kills every rank when one fails or the time limit passes, so a
rank that diverges (and would wait on a collective) fails the run instead
of hanging it.

``fn`` must be importable by name in a fresh interpreter: the workers live
in :mod:`cuba_tpu_torch.parallel.drive`.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch


def rank_device(device: str, rank: int) -> torch.device:
    """A rank's device: the host, or card ``rank % device_count`` (every
    rank on card 0 where there is one card)."""
    if device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(fn, rank, world_size, backend, device, timeout, tmp, args):
    import torch.distributed as dist

    try:
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'store')}",
                                world_size=world_size, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
        out = fn(rank, dist.group.WORLD, dev, *args)
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn: Callable, world_size: int, backend: str = "gloo", device: str = "cpu",
          timeout: float = 300.0, args: Sequence = ()) -> List[Dict[str, np.ndarray]]:
    """Run ``fn`` on ``world_size`` ranks and return each rank's arrays.

    ``backend``: "gloo" (the host, or several ranks on one card) or
    "nccl" (one card a rank).  Raises RuntimeError, with the failing
    ranks' tracebacks, when a rank exits non-zero, and TimeoutError when
    the ranks outlive ``timeout`` seconds; either way no rank is left
    running."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="cuba_spawn_") as tmp:
        procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                             args=(fn, r, world_size, backend, device, timeout, tmp,
                                   tuple(args)))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = timed_out = False
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    failed = True
                    break
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
        codes = [p.exitcode for p in procs]
        errors = []
        for r in range(world_size):
            path = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
        if timed_out:
            raise TimeoutError(f"ranks still running after {timeout} s (exit codes {codes})\n"
                               + "\n".join(errors))
        if failed or any(codes):
            raise RuntimeError(f"rank exit codes {codes}\n" + "\n".join(errors))
        out = []
        for r in range(world_size):
            with np.load(os.path.join(tmp, f"rank{r}.npz")) as f:
                out.append({k: f[k] for k in f.files})
        return out
