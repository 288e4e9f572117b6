"""The CUDA kernels of cuba_tpu_torch on the card (marker ``gpu``).

These tests need an NVIDIA GPU with nvcc and skip elsewhere.  The card's
machine has no JAX, so this file imports none and runs without the repo's
conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from cuba_tpu_torch import BAConfig, EdgeType, RobustKernelType
from cuba_tpu_torch.io import synthetic
from cuba_tpu_torch.ops import segmm

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ids(rng, n, num):
    ids = rng.integers(0, num, n)
    u = rng.random(n)
    return np.where(u < 0.1, -1, np.where(u > 0.95, num + 3, ids)).astype(np.int32)


@pytest.mark.parametrize("name", ["resident_gather", "windowed_gather", "tiled_gather"])
def test_gather_kernel_matches_plain(cuda, name):
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.standard_normal((12, 5000)).astype(np.float32)).to(cuda)
    ids = torch.from_numpy(_ids(rng, 70001, 5000)).to(cuda)
    args = {"resident_gather": (), "windowed_gather": (None, None),
            "tiled_gather": (None, None)}[name]
    before = segmm.LAUNCHES[name]
    got = getattr(segmm, name)(src, ids, *args)
    want = getattr(segmm, name + "_plain")(src, ids, *args)
    torch.cuda.synchronize()
    assert segmm.LAUNCHES[name] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["accum_segsum", "accum_segsum_windowed", "tiled_segsum"])
def test_segsum_kernel_matches_plain(cuda, name):
    rng = np.random.default_rng(1)
    vals = torch.from_numpy(rng.standard_normal((18, 70001)).astype(np.float32)).to(cuda)
    ids = torch.from_numpy(_ids(rng, 70001, 3000)).to(cuda)
    csr = segmm.segment_csr(ids, 3000, cuda)
    args = {"accum_segsum": (), "accum_segsum_windowed": (None, None),
            "tiled_segsum": (None, None)}[name]
    got = getattr(segmm, name)(vals, ids, 3000, *args, csr=csr)
    want = getattr(segmm, name + "_plain")(vals, ids, 3000, *args)
    bound = segmm.accum_segsum_plain(vals.abs(), ids, 3000)
    assert bool(((got - want).abs() <= 1e-5 * bound).all())
    # deterministic: a second launch gives the same bits
    assert torch.equal(got, getattr(segmm, name)(vals, ids, 3000, *args, csr=csr))


def test_kernel_wrappers_reject_bad_input(cuda):
    src = torch.zeros((3, 10), dtype=torch.float64, device=cuda)
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        segmm.resident_gather(src, ids)
    with pytest.raises(ValueError):
        segmm.resident_gather(torch.zeros((10, 3), device=cuda).T, ids)
    with pytest.raises(ValueError):
        segmm.resident_gather(torch.zeros((3, 10)), ids)


def test_slice_on_card_matches_plain(cuda):
    prob = synthetic.generate(num_poses=40, num_landmarks=600, seed=4)

    def run():
        ba = synthetic.build_graph(prob, BAConfig(dtype=torch.float32, solver="pcg",
                                                  device="cuda"))
        ba.set_robust_kernels(RobustKernelType.HUBER, np.sqrt(5.991), EdgeType.MONOCULAR)
        ba.set_robust_kernels(RobustKernelType.HUBER, np.sqrt(7.815), EdgeType.STEREO)
        ba.initialize()
        ba.optimize(6)
        return np.array([s.chi2 for s in ba.batch_statistics()])

    segmm.reset_launches()
    got = run()
    assert all(segmm.LAUNCHES[n] > 0 for n in ("tiled_gather", "tiled_segsum"))
    with segmm.use_plain():
        want = run()
    n = min(len(got), len(want))
    np.testing.assert_allclose(got[:n], want[:n], rtol=5e-3)
    assert got[-1] < got[0]
