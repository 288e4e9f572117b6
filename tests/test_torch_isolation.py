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

from cuba_tpu_torch.ops import segmm

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
                           BAConfig(solver="pcg"))
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


def test_sources_import_no_jax():
    pkg = os.path.join(REPO, "cuba_tpu_torch")
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(root, f)).read()
                for bad in ("import jax", "from jax", "import cuba_tpu.", "from cuba_tpu.",
                            "from cuba_tpu import", "torch.compile"):
                    assert bad not in text, (f, bad)


def test_kernel_source_and_binding_import_without_nvcc():
    src = open(segmm.KERNEL_SRC).read()
    for entry in ("cuba_gather_cols", "cuba_segsum_csr", "__global__"):
        assert entry in src
    assert "arch=compute_90a,code=sm_90a" in segmm._NVCC_FLAGS


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
