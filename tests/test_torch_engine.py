"""The whole slice through the public API: cuba_tpu_torch.BundleAdjustment
against cuba_tpu.BundleAdjustment on the same seeded graph, with the PCG,
the band (cyclic-reduction) and the dense (Cholesky) solvers.

fp64: the port (plain torch versions on the CPU) against cuba_tpu's XLA path
(``mxu="off"``): per-iteration chi² to 1e-6 relative, the bar of
tests/test_parity.py.  fp32: against cuba_tpu's rows path with the Pallas
kernels in interpret mode: 5e-3, the path-against-path bar of
tests/test_mxu_path.py.  The solver choice of ``solver="auto"`` is held to
cuba_tpu's engine.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuba_tpu
import cuba_tpu_torch
from cuba_tpu.io import synthetic as tpu_synthetic
from cuba_tpu.ops import robust as tpu_robust
from cuba_tpu.solver import engine as tpu_engine
from cuba_tpu.solver import mxu
from cuba_tpu.solver import structure as tpu_structure
from cuba_tpu_torch.io import synthetic
from cuba_tpu_torch.models.types import MonoEdge
from cuba_tpu_torch.solver import engine
from cuba_tpu_torch.solver import structure

torch.set_num_threads(1)

MONO_DELTA = float(np.sqrt(5.991))
STEREO_DELTA = float(np.sqrt(7.815))


def _run(pkg, syn, config, robust=True, fix_every=0, niters=8):
    """initialize() + optimize(niters) on the 10-pose / 90-landmark graph
    (one padded block of 128 poses: two CR blocks on the band path)."""
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
                   cuba_tpu_torch.BAConfig(dtype=torch.float64, solver="pcg", device="cpu"),
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
                  cuba_tpu_torch.BAConfig(dtype=torch.float32, solver="pcg", device="cpu"))
    n = min(len(got), len(want))
    assert n >= 5
    np.testing.assert_allclose(got[:n], want[:n], rtol=5e-3)
    assert got[n - 1] < got[0]


def test_optimize_before_initialize_raises():
    ba = cuba_tpu_torch.BundleAdjustment(cuba_tpu_torch.BAConfig(solver="pcg", device="cpu"))
    with pytest.raises(RuntimeError, match="initialize"):
        ba.optimize(1)


@pytest.mark.parametrize("robust", [False, True])
def test_fp64_band_cr_trajectory_matches_xla_path(robust):
    _, want = _run(cuba_tpu, tpu_synthetic,
                   cuba_tpu.BAConfig(dtype=jnp.float64, mxu="off", solver="band_cr"), robust)
    ba, got = _run(cuba_tpu_torch, synthetic,
                   cuba_tpu_torch.BAConfig(dtype=torch.float64, solver="band_cr",
                                           device="cpu"), robust)
    assert ba._engine.solver == "band_cr" and ba._engine.band_m == 2
    assert ba.last_result.cg_steps == 0
    assert len(got) == len(want) >= 5
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[-1] < got[0]


def test_fp32_band_cr_trajectory_matches_interpret_path():
    _, want = _run(cuba_tpu, tpu_synthetic,
                   cuba_tpu.BAConfig(dtype=jnp.float32, mxu="interpret", solver="band_cr"))
    ba, got = _run(cuba_tpu_torch, synthetic,
                   cuba_tpu_torch.BAConfig(dtype=torch.float32, solver="band_cr", device="cpu"))
    n = min(len(got), len(want))
    assert n >= 5
    np.testing.assert_allclose(got[:n], want[:n], rtol=5e-3)
    assert got[n - 1] < got[0]
    r = ba.last_result
    # per attempt: the gain-ratio read and the fp32 boost-retry read
    assert r.host_reads == 2 * r.nattempts + 1


@pytest.mark.parametrize("robust", [False, True])
def test_fp64_dense_trajectory_matches_xla_path(robust):
    _, want = _run(cuba_tpu, tpu_synthetic,
                   cuba_tpu.BAConfig(dtype=jnp.float64, mxu="off", solver="dense_cholesky"),
                   robust)
    ba, got = _run(cuba_tpu_torch, synthetic,
                   cuba_tpu_torch.BAConfig(dtype=torch.float64, solver="dense_cholesky",
                                           device="cpu"), robust)
    assert ba._engine.solver == "dense_cholesky" and ba.last_result.cg_steps == 0
    assert len(got) == len(want) >= 5
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[-1] < got[0]
    r = ba.last_result
    # fp64: no boost retry, so one read per attempt and one per optimize
    assert r.host_reads == r.nattempts + 1


def test_fp32_dense_trajectory_matches_interpret_path():
    _, want = _run(cuba_tpu, tpu_synthetic,
                   cuba_tpu.BAConfig(dtype=jnp.float32, mxu="interpret", solver="dense_cholesky"))
    ba, got = _run(cuba_tpu_torch, synthetic,
                   cuba_tpu_torch.BAConfig(dtype=torch.float32, solver="auto", device="cpu"))
    assert ba._engine.solver == "dense_cholesky"
    n = min(len(got), len(want))
    assert n >= 5
    np.testing.assert_allclose(got[:n], want[:n], rtol=5e-3)
    assert got[n - 1] < got[0]
    r = ba.last_result
    # per attempt: the gain-ratio read and one boost-retry read (the first
    # factorisation holds at this size)
    assert r.host_reads == 2 * r.nattempts + 1


def _chord_graph(config):
    """A 200-pose odometry graph plus three landmarks near pose 5 seen again
    from pose 150: banded plus a few loop-closure blocks two CR blocks off
    the diagonal (which no pose fold can band)."""
    prob = synthetic.generate(num_poses=200, num_landmarks=1000, seed=4)
    ba = synthetic.build_graph(prob, config)
    near5 = np.unique(prob.mono_l[prob.mono_p == 5])[:3]
    for lm in near5:
        ba.add_monocular_edge(MonoEdge(np.array([600.0, 180.0]), 1.0, ba.pose_vertex(150),
                                       ba.landmark_vertex(int(lm))))
    return ba


@pytest.mark.parametrize("solver", ["band_lr"])
def test_unported_solver_raises(solver):
    """The solver that raised before it was ported now runs: 'band_lr' on a
    banded graph with loop-closure blocks resolves to the Woodbury solver,
    over the v2 band formation's out-of-band blocks."""
    ba = _chord_graph(cuba_tpu_torch.BAConfig(solver=solver, device="cpu"))
    ba.initialize()
    ba.optimize(4)
    chis = [s.chi2 for s in ba.batch_statistics()]
    eng = ba._engine
    assert eng.solver == "band_lr" and eng.path == "v2" and eng.plan.lr_nob > 0
    assert np.all(np.isfinite(chis)) and chis[-1] < chis[0]


@pytest.mark.parametrize("solver", ["auto", "dense_cholesky"])
def test_dense_solver_runs(solver):
    """The graphs that raised before the dense solver was ported: 'auto' on
    a graph under 8 CR blocks resolves to it."""
    ba = synthetic.build_graph(synthetic.generate(num_poses=6, num_landmarks=40, seed=1),
                               cuba_tpu_torch.BAConfig(solver=solver, device="cpu"))
    ba.initialize()
    ba.optimize(4)
    chis = [s.chi2 for s in ba.batch_statistics()]
    assert ba._engine.solver == "dense_cholesky" and ba._engine.pad_blocks == 128
    assert np.all(np.isfinite(chis)) and chis[-1] < chis[0]


def _both_structures(args):
    return (structure.build_structure_from_arrays(*args),
            tpu_structure.build_structure_from_arrays(*args))


def _generated(num_poses, num_landmarks, seed, **kw):
    prob = tpu_synthetic.generate(num_poses=num_poses, num_landmarks=num_landmarks,
                                  seed=seed, **kw)
    fp = np.zeros(num_poses, bool)
    fp[prob.fixed_poses] = True
    return (prob.qs, prob.ts, np.tile(prob.cam, (num_poses, 1)), prob.Xws, fp,
            np.zeros(num_landmarks, bool), prob.mono_p, prob.mono_l, prob.mono_z,
            prob.mono_w, prob.stereo_p, prob.stereo_l, prob.stereo_z, prob.stereo_w)


def _scattered():
    """tests/test_band_cr.py's unbanded problem: scattered covisibility."""
    rng = np.random.default_rng(0)
    num_p, num_l = 200, 1600
    qs = np.tile(np.array([0.0, 0, 0, 1]), (num_p, 1))
    ts = rng.normal(size=(num_p, 3)) * 0.1
    cams = np.tile(np.array([500.0, 500, 320, 240, 0.1]), (num_p, 1))
    Xws = rng.normal(size=(num_l, 3)) + np.array([0, 0, 5.0])
    fp = np.zeros(num_p, bool)
    fp[0] = True
    mp, ml = [], []
    for lm in range(num_l):
        for p in rng.choice(num_p, size=4, replace=False):
            mp.append(p)
            ml.append(lm)
    e = np.zeros((0,), np.int32)
    return (qs, ts, cams, Xws, fp, np.zeros(num_l, bool),
            np.asarray(mp, np.int32), np.asarray(ml, np.int32),
            rng.normal(size=(len(mp), 2)) * 10 + np.array([320.0, 240]),
            np.ones(len(mp)), e, e, np.zeros((0, 3)), np.zeros(0))


KERNELS = ((tpu_robust.HUBER, MONO_DELTA), (tpu_robust.HUBER, STEREO_DELTA))


@pytest.mark.parametrize("case", ["small", "banded", "unbanded"])
def test_auto_resolves_as_cuba_tpu(case):
    args = {"small": lambda: _generated(10, 90, 7),
            "banded": lambda: _generated(450, 1800, 3, mean_obs_per_landmark=3.0),
            "unbanded": _scattered}[case]()
    port_s, ref_s = _both_structures(args)
    ref = tpu_engine.BlockSolverEngine(ref_s, KERNELS,
                                       cuba_tpu.BAConfig(dtype=jnp.float64, mxu="off"))
    solver, band_m, pad_blocks, _lr = engine.resolve_solver(
        port_s, cuba_tpu_torch.BAConfig(device="cpu"))
    assert (solver, band_m, pad_blocks) == (ref.solver, ref.band_m, ref.pad_blocks)
    assert solver == {"small": "dense_cholesky", "banded": "band_cr",
                      "unbanded": "dense_cholesky"}[case]
    eng = engine.BlockSolverEngine(port_s, KERNELS, cuba_tpu_torch.BAConfig(device="cpu"))
    assert eng.solver == solver and eng.band_m == ref.band_m
    if case == "unbanded":
        # scattered covisibility: cuba_tpu's window plans fail (plan_mxu
        # gives ok False: its AoS path); the port's bands are over _WG_MAX,
        # so it forms the dense matrix by v1
        plans, _ = mxu.plan_mxu(ref_s, pad_blocks, need_dense=True, wire_pack=False)
        assert not plans.ok and eng.path == "v1" and eng.rc.dense_table is None
        return
    if solver == "band_cr":
        assert eng.band_m >= 8 and eng.rc.dense_table is None
    else:
        assert tuple(eng.rc.dense_table.shape) == (pad_blocks, pad_blocks)


def test_band_cr_rejects_unbanded():
    port_s, _ = _both_structures(_scattered())
    with pytest.raises(ValueError, match="band"):
        engine.BlockSolverEngine(port_s, KERNELS,
                                 cuba_tpu_torch.BAConfig(solver="band_cr", device="cpu"))


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
