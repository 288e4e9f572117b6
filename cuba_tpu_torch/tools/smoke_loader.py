"""This checkout's ``chip_smoke.py`` over the ``cuba_tpu_torch`` package
of another tree, for the ``probe_*`` scripts' ``--root DIR``.

The probes time and bound DIR's kernels with one yardstick, this
checkout's ``tools/roofline.py`` (peak rates, work counts, bound,
``interleaved_times``) and ``tools/graphs.py`` (the graphs), whatever DIR
holds: two trees measured in one call get the same bound and the same
timing, and a tree that has no ``roofline.py`` or ``graphs.py`` can be
measured too.  Import this module before DIR goes on ``sys.path``.
"""

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
SHARED = ("roofline", "graphs")  # this checkout's, under their package names


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def load_smoke(root: str = REPO):
    """Put ``root`` first on ``sys.path``; load this checkout's SHARED
    modules as ``cuba_tpu_torch.tools.<name>`` (their own imports of the
    package resolve to ``root``'s) and then its ``chip_smoke.py``, which
    takes them.  Returns the ``chip_smoke`` module."""
    sys.path.insert(0, os.path.abspath(root))
    for name in SHARED:
        _load(f"cuba_tpu_torch.tools.{name}", os.path.join(HERE, f"{name}.py"))
    return _load("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
