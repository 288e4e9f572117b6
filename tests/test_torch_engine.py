"""The whole slice through the public API: cuba_tpu_torch.BundleAdjustment
against cuba_tpu.BundleAdjustment on the same seeded graph, PCG solver.

fp64: the port (plain torch versions on the CPU) against cuba_tpu's XLA path
(``mxu="off"``): per-iteration chi² to 1e-6 relative, the bar of
tests/test_parity.py.  fp32: against cuba_tpu's rows path with the Pallas
kernels in interpret mode: 5e-3, the path-against-path bar of
tests/test_mxu_path.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuba_tpu
import cuba_tpu_torch
from cuba_tpu.io import synthetic as tpu_synthetic
from cuba_tpu_torch.io import synthetic

torch.set_num_threads(1)

MONO_DELTA = float(np.sqrt(5.991))
STEREO_DELTA = float(np.sqrt(7.815))


def _run(pkg, syn, config, robust=True, fix_every=0, niters=8):
    ba = syn.build_graph(syn.generate(num_poses=10, num_landmarks=90, seed=7), config)
    if fix_every:  # fixed landmarks: edges keep their residuals, lose their Hll/Hpl terms
        for j in range(0, 90, fix_every):
            ba.landmark_vertex(j).fixed = True
    if robust:
        ba.set_robust_kernels(pkg.RobustKernelType.HUBER, MONO_DELTA, pkg.EdgeType.MONOCULAR)
        ba.set_robust_kernels(pkg.RobustKernelType.HUBER, STEREO_DELTA, pkg.EdgeType.STEREO)
    ba.initialize()
    ba.optimize(niters)
    return ba, np.array([s.chi2 for s in ba.batch_statistics()])


@pytest.mark.parametrize("robust,fix_every", [(False, 0), (True, 0), (True, 9)])
def test_fp64_trajectory_matches_xla_path(robust, fix_every):
    tba, want = _run(cuba_tpu, tpu_synthetic,
                     cuba_tpu.BAConfig(dtype=jnp.float64, mxu="off", solver="pcg"),
                     robust, fix_every)
    ba, got = _run(cuba_tpu_torch, synthetic,
                   cuba_tpu_torch.BAConfig(dtype=torch.float64, solver="pcg"),
                   robust, fix_every)
    assert len(got) == len(want) >= 5
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[-1] < got[0]
    # estimates written back into the vertices, and per-edge chi²
    for i in (0, 5, 9):
        np.testing.assert_allclose(ba.pose_vertex(i).t, tba.pose_vertex(i).t,
                                   rtol=1e-6, atol=1e-8)
    for e, te in zip(list(ba._mono_edges)[:20], list(tba._mono_edges)[:20]):
        np.testing.assert_allclose(ba.chi_squared(e), tba.chi_squared(te),
                                   rtol=1e-6, atol=1e-9)


def test_fp32_trajectory_matches_interpret_path():
    _, want = _run(cuba_tpu, tpu_synthetic,
                   cuba_tpu.BAConfig(dtype=jnp.float32, mxu="interpret", solver="pcg"))
    _, got = _run(cuba_tpu_torch, synthetic,
                  cuba_tpu_torch.BAConfig(dtype=torch.float32, solver="pcg"))
    n = min(len(got), len(want))
    assert n >= 5
    np.testing.assert_allclose(got[:n], want[:n], rtol=5e-3)
    assert got[n - 1] < got[0]


def test_optimize_before_initialize_raises():
    ba = cuba_tpu_torch.BundleAdjustment(cuba_tpu_torch.BAConfig(solver="pcg"))
    with pytest.raises(RuntimeError, match="initialize"):
        ba.optimize(1)


@pytest.mark.parametrize("solver", ["auto", "band_cr", "dense_cholesky"])
def test_unported_solver_raises(solver):
    ba = synthetic.build_graph(synthetic.generate(num_poses=6, num_landmarks=40, seed=1),
                               cuba_tpu_torch.BAConfig(solver=solver))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ba.initialize()


def test_camelcase_aliases_exist():
    ba = cuba_tpu_torch.CudaBundleAdjustment()
    for name in ("addPoseVertex", "addLandmarkVertex", "addMonocularEdge", "addStereoEdge",
                 "poseVertex", "landmarkVertex", "removePoseVertex", "removeLandmarkVertex",
                 "removeEdge", "setRobustKernels", "batchStatistics", "chiSquared"):
        assert getattr(ba, name) == getattr(ba, _snake(name)), name
    assert cuba_tpu_torch.VertexP is cuba_tpu_torch.PoseVertex
    assert cuba_tpu_torch.Edge3D is cuba_tpu_torch.StereoEdge
    assert sorted(cuba_tpu_torch.__all__) == sorted(cuba_tpu.__all__)


def _snake(name):
    return "".join("_" + c.lower() if c.isupper() else c for c in name)
