"""cuba_tpu_torch stands alone: no JAX, no cuba_tpu, and CUDA only where asked.

The card the port runs on has no JAX, so the package must import and run
without it; code for the card must fail loudly, not fall back, on a machine
without one.
"""

import os
import subprocess
import sys

import pytest
import torch

from cuba_tpu_torch.ops import cudalib, segmm
from cuba_tpu_torch.solver import trisolve

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DRIVE = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import cuba_tpu_torch
from cuba_tpu_torch import BAConfig, EdgeType, RobustKernelType
from cuba_tpu_torch.io import synthetic
ba = synthetic.build_graph(synthetic.generate(num_poses=6, num_landmarks=50, seed=2),
                           BAConfig(solver="pcg", device="cpu"))
ba.set_robust_kernels(RobustKernelType.HUBER, np.sqrt(5.991), EdgeType.MONOCULAR)
ba.initialize()
ba.optimize(3)
chis = [s.chi2 for s in ba.batch_statistics()]
assert len(chis) == 3 and chis[-1] < chis[0], chis
leaked = sorted(m for m in sys.modules
                if m in ("jax", "cuba_tpu") or m.startswith(("jax.", "cuba_tpu.")))
assert not leaked, leaked
print("isolated", chis[-1])
"""


def _python(code_or_args, cwd, **kw):
    args = ["-c", code_or_args] if isinstance(code_or_args, str) else code_or_args
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("PYTHONSTARTUP", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300, **kw)


def test_port_runs_without_jax():
    r = _python(_DRIVE, REPO)
    assert r.returncode == 0, r.stderr
    assert "isolated" in r.stdout


def test_dense_path_runs_without_jax():
    """The dense solver (``solver="auto"`` on a graph under 8 CR blocks)
    with its trisolve modules, in a process without JAX."""
    drive = _DRIVE.replace('BAConfig(solver="pcg", device="cpu")',
                           'BAConfig(device="cpu")').replace(
        "ba.optimize(3)", 'ba.optimize(3)\nassert ba._engine.solver == "dense_cholesky"')
    r = _python(drive, REPO)
    assert r.returncode == 0, r.stderr
    assert "isolated" in r.stdout


def test_aos_path_runs_without_jax():
    """The AoS path (here a pose-only problem, which the planner sends
    there) with its assembly and small-solve modules, without JAX."""
    drive = _DRIVE.replace("ba.initialize()", "for j in range(50):\n"
                           "    ba.landmark_vertex(j).fixed = True\nba.initialize()").replace(
        "ba.optimize(3)", 'ba.optimize(3)\nassert ba._engine.path == "aos"')
    r = _python(drive, REPO)
    assert r.returncode == 0, r.stderr
    assert "isolated" in r.stdout


_API_DRIVE = """
import contextlib, io, os, shutil, sys, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
from cuba_tpu_torch import BAConfig, native
from cuba_tpu_torch.io import bal, json_io, synthetic
from cuba_tpu_torch.reference.solver import RefProblem, ReferenceSolver
from cuba_tpu_torch.samples import sample_bal
from cuba_tpu_torch.solver.engine import PROFILE_ITEMS
cfg = BAConfig(dtype=torch.float64, device="cpu")
tmp = tempfile.mkdtemp()
src = synthetic.build_graph(synthetic.generate(num_poses=6, num_landmarks=50, seed=2), cfg)
json_io.write_graph(src, os.path.join(tmp, "g.json"))
ba = json_io.read_graph(os.path.join(tmp, "g.json"), cfg)
ba.initialize()
ref = ReferenceSolver(RefProblem.from_structure(ba._engine.structure, ba._kernels))
ba.optimize(3, profile=True)
chis = [s.chi2 for s in ba.batch_statistics()]
ref_chis = ref.optimize(3)
assert np.allclose(chis, ref_chis, rtol=1e-6), (chis, ref_chis)
assert tuple(ba.time_profile()) == PROFILE_ITEMS and ba.time_profile()["6: Numerical Decomposition"] > 0
ba.save_checkpoint(os.path.join(tmp, "c.npz"))
again = json_io.read_graph(os.path.join(tmp, "g.json"), cfg)
again.load_checkpoint(os.path.join(tmp, "c.npz"))
assert [s.chi2 for s in again.batch_statistics()] == chis
assert all(np.array_equal(again.pose_vertex(i).q, ba.pose_vertex(i).q) for i in range(6))
toy = os.path.join(%(repo)r, "data", "bal_toy.txt.gz")
b = bal.read_bal(toy, cfg)
b.initialize()
b.optimize(2)
out = io.StringIO()
with contextlib.redirect_stdout(out):
    sample_bal.main([toy, "--iters", "2", "--cpu"])
assert "reprojection RMSE" in out.getvalue(), out.getvalue()
assert os.path.dirname(native.SRC) == os.path.join(%(repo)r, "cuba_tpu_torch", "csrc")
assert native.backend() == "c++" or shutil.which("g++") is None
leaked = sorted(m for m in sys.modules
                if m in ("jax", "cuba_tpu") or m.startswith(("jax.", "cuba_tpu.")))
assert not leaked, leaked
print("isolated", chis[-1])
""" % {"repo": REPO}


def test_public_api_runs_without_jax():
    """JSON and BAL readers, the oracle's copy, the profiled loop, the time
    profile, a checkpoint round trip and a sample, in a process without
    JAX, with the symbolic pass built from the port's own source."""
    r = _python(_API_DRIVE, REPO)
    assert r.returncode == 0, r.stderr
    assert "isolated" in r.stdout


def test_spawned_ranks_import_no_jax():
    """The ranks of a sharded run (``parallel.launch.spawn``, a fresh
    interpreter each, started from this process, which holds JAX) import
    neither JAX nor cuba_tpu: ``drive.run_cases`` asserts it on entry and
    reports the rank's modules at its end."""
    import numpy as np

    from cuba_tpu_torch.io import synthetic
    from cuba_tpu_torch.parallel import drive, launch

    case = dict(name="g", kind="api", iters=2, config=dict(dtype=torch.float64),
                problem=synthetic.generate(num_poses=6, num_landmarks=50, seed=2))
    res = launch.spawn(drive.run_cases, 2, device="cpu", args=([case],), timeout=120)
    for r in res:
        assert r["modules"].size == 0, r["modules"]
        assert np.array_equal(r["g.chis"], res[0]["g.chis"]) and r["g.chis"][-1] < r["g.chis"][0]


def test_multichip_sample_runs_without_jax():
    r = _python(["-m", "cuba_tpu_torch.samples.sample_multichip", "--devices", "2", "--device",
                 "cpu", "--poses", "8", "--landmarks", "80", "--iters", "2"], REPO)
    assert r.returncode == 0, r.stderr
    assert "ranks agree bit for bit: True" in r.stdout


def test_port_opens_and_builds_nothing_of_cuba_tpu():
    """No module of the port names a path under ``cuba_tpu/``: a quoted
    ``"cuba_tpu"`` path component or a ``"cuba_tpu/..."`` string."""
    import re

    from cuba_tpu_torch import native

    pkg = os.path.join(REPO, "cuba_tpu_torch")
    assert os.path.commonpath([native.SRC, pkg]) == pkg
    assert os.path.commonpath([native.BUILD_DIR, pkg]) == pkg
    for name in cudalib.SOURCES.values():
        assert os.path.commonpath([name, pkg]) == pkg
    pattern = re.compile(r"[\"']cuba_tpu[\"'/]")
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith((".py", ".cu")):
                text = open(os.path.join(root, f)).read()
                assert not pattern.search(text), os.path.join(root, f)


def test_sources_import_no_jax():
    pkg = os.path.join(REPO, "cuba_tpu_torch")
    seen = set()
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(pkg):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        seen.add(os.path.basename(path))
        text = open(path).read()
        for bad in ("import jax", "from jax", "import cuba_tpu.", "from cuba_tpu.",
                    "from cuba_tpu import", "torch.compile", "import bench", "from bench"):
            assert bad not in text, (path, bad)
    assert {"assembly.py", "schur.py", "pcg.py", "projection.py", "jacobians.py",
            "smallmat.py", "rows.py", "band_cr.py", "chip_smoke.py", "json_io.py", "bal.py",
            "solver.py", "sample_ba_from_file.py", "sample_bal.py",
            "sample_comparison_with_reference.py", "sharding.py", "rows_shard.py", "comm.py",
            "launch.py", "drive.py", "sample_multichip.py"} <= seen


def test_kernel_source_and_binding_import_without_nvcc():
    for path, entries, bound in (
            (segmm.KERNEL_SRC, ("cuba_gather_cols", "cuba_segsum_csr", "cuba_schur_fused",
                                "cuba_compact_to_band", "cuba_compact_to_dense",
                                "cuba_band_transpose"), segmm._SIGNATURES),
            (trisolve.KERNEL_SRC, ("cuba_extract_diag_blocks", "cuba_solve_lower",
                                   "cuba_solve_lower_work", "cuba_solve_upper",
                                   "cuba_solve_upper_work", "cuba_matvec"),
             trisolve._SIGNATURES)):
        src = open(path).read()
        for entry in entries + ("__global__",):
            assert entry in src, (path, entry)
        # every entry point ctypes binds is defined with the argument count it binds
        for entry, argtypes in bound.items():
            head = src.split(f" {entry}(", 1)
            assert len(head) == 2 and head[0].rstrip().endswith(("int", "int64_t")), entry
            params = head[1].split(")", 1)[0]
            assert params.count(",") + 1 == len(argtypes), (entry, params)
    assert sorted(cudalib.SOURCES.values()) == sorted([segmm.KERNEL_SRC, trisolve.KERNEL_SRC])
    assert "arch=compute_90a,code=sm_90a" in cudalib.NVCC_FLAGS


def test_cuda_only_calls_raise_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    import cuba_tpu_torch
    from cuba_tpu_torch.io import synthetic

    ba = synthetic.build_graph(synthetic.generate(num_poses=6, num_landmarks=40, seed=1),
                               cuba_tpu_torch.BAConfig(solver="pcg", device="cuda"))
    with pytest.raises((RuntimeError, AssertionError)):
        ba.initialize()
    meta = torch.empty((3, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        segmm.tiled_gather(meta, torch.zeros(8, dtype=torch.int32, device="meta"), None, None)
    with pytest.raises(ValueError, match="no kernel"):
        trisolve.matvec(torch.empty((8, 8), device="meta"), torch.empty(8, device="meta"))


def test_default_device_is_the_card():
    import cuba_tpu_torch

    assert cuba_tpu_torch.BAConfig().resolve_device() == torch.device("cuda")
    assert cuba_tpu_torch.BAConfig(device="cpu").resolve_device() == torch.device("cpu")


def test_default_config_refuses_to_run_on_the_host():
    """Without a CUDA device, a default config fails at initialize() and
    names the way to the host; it never carries on there."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    import cuba_tpu_torch
    from cuba_tpu_torch.io import synthetic

    ba = synthetic.build_graph(synthetic.generate(num_poses=6, num_landmarks=40, seed=1))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ba.initialize()
    assert ba._engine is None
    ba = cuba_tpu_torch.BundleAdjustment()
    assert ba.config.device == "cuda"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    script = os.path.join(REPO, "chip_smoke.py")
    r = _python([script, "--num-poses", "8"], REPO)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    # alone, without the package beside it
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(script).read())
    r = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300, env={k: v for k, v in os.environ.items()
                                                     if k != "PYTHONPATH"})
    assert r.returncode != 0 and '"ok"' not in r.stdout
