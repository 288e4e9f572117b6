"""The AoS path (cuba_tpu's non-MXU branch) against cuba_tpu, on the CPU.

The engine takes it where the rows planner finds no plan: pose-only and
landmark-only problems, structures without Hpl slots and Schur chunk plans
that do not hold.  cuba_tpu also takes it where its TPU window plans fail
(scattered covisibility).  Here:

- the math ops (projection, Jacobians, fixed-size solves) against
  cuba_tpu's in fp64 (1e-12) and the Jacobians against ``torch.func.jacfwd``
  of the residual (1e-8 landmark, 1e-7 pose: the bars of tests/test_ops.py);
- the assembly, ``assemble_dense`` and the PCG against cuba_tpu's in fp64
  (1e-10: the same sums in other orders);
- LM trajectories on the AoS path against cuba_tpu's XLA path: each solver
  in fp64 (1e-6, the bar of tests/test_parity.py) and the scattered graph
  in fp32 (5e-3), each with the planner made to find no plan, and
  pose-only and landmark-only problems in fp64 (1e-6), which must
  descend.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import cuba_tpu
import cuba_tpu_torch
from cuba_tpu.io import synthetic as tpu_synthetic
from cuba_tpu.ops import jacobians as tpu_jacobians
from cuba_tpu.ops import projection as tpu_projection
from cuba_tpu.ops import smallmat as tpu_smallmat
from cuba_tpu.solver import assembly as tpu_assembly
from cuba_tpu.solver import engine as tpu_engine
from cuba_tpu.solver import mxu
from cuba_tpu.solver import pcg as tpu_pcg
from cuba_tpu.solver import schur as tpu_schur
from cuba_tpu.solver import structure as tpu_structure
from cuba_tpu_torch.interop import structure_from_numpy
from cuba_tpu_torch.io import synthetic
from cuba_tpu_torch.ops import jacobians, projection, se3, smallmat
from cuba_tpu_torch.solver import assembly, engine, pcg, rows, schur

torch.set_num_threads(1)

MONO_DELTA = float(np.sqrt(5.991))
STEREO_DELTA = float(np.sqrt(7.815))
KERNELS = ((1, MONO_DELTA), (1, STEREO_DELTA))


def _scene(n, seed=0):
    """Random cameras and points in front of them (tests/test_ops.py)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[q[:, 3] < 0] *= -1
    t = rng.normal(size=(n, 3)) * 0.1
    cam = np.tile(np.array([718.856, 718.856, 607.1928, 185.2157, 386.1448]), (n, 1))
    Xc = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(2.0, 30.0, n)], -1)
    R = Rotation.from_quat(q).as_matrix()
    Xw = np.einsum("nji,nj->ni", R, Xc - t)
    return q, t, cam, Xw


@pytest.mark.parametrize("mdim", [2, 3])
def test_projection_matches_cuba_tpu(mdim):
    q, t, cam, Xw = _scene(32)
    Xc = projection.world_to_camera(*(torch.from_numpy(a) for a in (q, t, Xw)))
    want_Xc = tpu_projection.world_to_camera(*(jnp.asarray(a) for a in (q, t, Xw)))
    np.testing.assert_allclose(Xc.numpy(), np.asarray(want_Xc), rtol=0, atol=1e-12)
    got = projection.project(Xc, torch.from_numpy(cam), mdim).numpy()
    want = tpu_projection.project(want_Xc, jnp.asarray(cam), mdim)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("mdim", [2, 3])
def test_jacobians_match_jacfwd_and_cuba_tpu(mdim):
    q, t, cam, Xw = (torch.from_numpy(a) for a in _scene(16, seed=1))

    def resid_l(Xw_i, q_i, t_i, cam_i):
        return projection.project(projection.world_to_camera(q_i, t_i, Xw_i), cam_i, mdim)

    def resid_p(delta, q_i, t_i, Xw_i, cam_i):
        qn, tn = se3.update_pose(delta, q_i, t_i)
        return projection.project(projection.world_to_camera(qn, tn, Xw_i), cam_i, mdim)

    JL_auto = torch.func.vmap(torch.func.jacfwd(resid_l))(Xw, q, t, cam)
    JP_auto = torch.func.vmap(torch.func.jacfwd(resid_p))(torch.zeros(16, 6, dtype=q.dtype),
                                                         q, t, Xw, cam)
    JP, JL = jacobians.compute(projection.world_to_camera(q, t, Xw), q, cam, mdim)
    np.testing.assert_allclose(JL.numpy(), -JL_auto.numpy(), atol=1e-8)
    np.testing.assert_allclose(JP.numpy(), -JP_auto.numpy(), atol=1e-7)
    Xc_j = tpu_projection.world_to_camera(*(jnp.asarray(a.numpy()) for a in (q, t, Xw)))
    JPt, JLt = tpu_jacobians.compute(Xc_j, jnp.asarray(q.numpy()), jnp.asarray(cam.numpy()),
                                     mdim)
    np.testing.assert_allclose(JP.numpy(), np.asarray(JPt), rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(JL.numpy(), np.asarray(JLt), rtol=1e-12, atol=1e-9)


def test_small_solves_match_cuba_tpu():
    rng = np.random.default_rng(2)
    G6 = rng.normal(size=(64, 6, 6))
    H6 = G6 @ np.swapaxes(G6, 1, 2) + np.eye(6)
    b6 = rng.normal(size=(64, 6))
    H3, b3 = H6[:, :3, :3], b6[:, :3]
    got6 = smallmat.solve_sym6x6(torch.from_numpy(H6), torch.from_numpy(b6)).numpy()
    np.testing.assert_allclose(got6, np.linalg.solve(H6, b6[..., None])[..., 0], rtol=1e-9)
    np.testing.assert_allclose(got6, np.asarray(tpu_smallmat.solve_sym6x6(H6, b6)),
                               rtol=1e-12, atol=1e-12)
    got3 = smallmat.solve_sym3x3(torch.from_numpy(H3), torch.from_numpy(b3)).numpy()
    np.testing.assert_allclose(got3, np.asarray(tpu_smallmat.solve_sym3x3(H3, b3)),
                               rtol=1e-12, atol=1e-12)
    inv3 = smallmat.sym3x3_inv(torch.from_numpy(H3)).numpy()
    np.testing.assert_allclose(inv3, np.linalg.inv(H3), rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------------------
# assembly, Schur and PCG on one seeded structure
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def aos_system():
    """The 10-pose graph of tests/test_torch_engine.py (every 9th landmark
    fixed) assembled by both packages in fp64 at the initial state."""
    prob = tpu_synthetic.generate(num_poses=10, num_landmarks=90, seed=7)
    fl = np.zeros(90, bool)
    fl[::9] = True
    fp = np.zeros(10, bool)
    fp[prob.fixed_poses] = True
    s = tpu_structure.build_structure_from_arrays(
        prob.qs, prob.ts, np.tile(prob.cam, (10, 1)), prob.Xws, fp, fl,
        prob.mono_p, prob.mono_l, prob.mono_z, prob.mono_w,
        prob.stereo_p, prob.stereo_l, prob.stereo_z, prob.stereo_w)
    ps = structure_from_numpy(s)
    Em = s.mono.count
    tec = [tpu_assembly.EdgeConsts(*(jnp.asarray(a) for a in (
        e.measurements, e.omegas, e.pose_idx, e.lm_idx, e2h)))
        for e, e2h in ((s.mono, s.edge2hpl[:Em]), (s.stereo, s.edge2hpl[Em:]))]
    pec = [assembly.edge_consts(e.measurements, e.omegas, e.pose_idx, e.lm_idx, e2h, s.num_p,
                                s.num_l, s.n_hpl, "cpu", torch.float64)
           for e, e2h in ((ps.mono, ps.edge2hpl[:Em]), (ps.stereo, ps.edge2hpl[Em:]))]
    st = [np.asarray(a, np.float64) for a in (s.qs, s.ts, s.cams, s.Xws)]
    tres = [tpu_assembly.edge_residuals(*(jnp.asarray(a) for a in st[:3]), jnp.asarray(st[3]),
                                        ec, d) for ec, d in zip(tec, (2, 3))]
    want = tpu_assembly.build_system(jnp.asarray(st[0]), jnp.asarray(st[2]), s.num_p, s.num_l,
                                     s.n_hpl, tec[0], tec[1], *tres[0], *tres[1], KERNELS)
    pt = [torch.from_numpy(a) for a in st]
    pres = [assembly.edge_residuals(pt[0], pt[1], pt[2], pt[3], ec, d)
            for ec, d in zip(pec, (2, 3))]
    got = assembly.build_system(pt[0], pt[2], s.num_p, s.num_l, s.n_hpl,
                                [(ec, e, X, d) for ec, (e, X), d in zip(pec, pres, (2, 3))],
                                KERNELS)
    tsc = tpu_schur.SchurConsts(*(jnp.asarray(a) for a in (
        s.hpl_row, s.hpl_col, s.hsc_row, s.hsc_col, s.mul_i, s.mul_j, s.mul_k)))
    return s, tres, pres, want, got, tsc, schur.schur_consts(ps, "cpu")


def test_residuals_and_chi_match_cuba_tpu(aos_system):
    s, tres, pres, *_ = aos_system
    for (te, tX), (pe, pX), e, k in zip(tres, pres, (s.mono, s.stereo), KERNELS):
        np.testing.assert_allclose(pe.numpy(), np.asarray(te), rtol=1e-12, atol=1e-9)
        np.testing.assert_allclose(pX.numpy(), np.asarray(tX), rtol=1e-12, atol=1e-12)
        got = assembly.chi_sum(pe, torch.from_numpy(e.omegas), k, torch.float64)
        want = tpu_assembly.chi_sum(te, jnp.asarray(e.omegas), k, jnp.float64)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


def test_build_system_matches_cuba_tpu(aos_system):
    _s, _tres, _pres, want, got, *_ = aos_system
    for name, g, w in zip(("Hpp", "bp", "Hll", "bl", "Hpl"), got, want):
        scale = float(np.abs(np.asarray(w)).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-10 * scale,
                                   err_msg=name)


def _damped(sys, lam):
    Hpp, bp, Hll, bl, Hpl = sys
    eye6, eye3 = np.eye(6), np.eye(3)
    return Hpp + lam * eye6, bp, Hll + lam * eye3, bl, Hpl


def test_schur_and_dense_assembly_match_cuba_tpu(aos_system):
    s, _tres, _pres, want, got, tsc, sc = aos_system
    lam = 1e-2
    Hpp_d, bp, Hll_d, bl, Hpl = (np.asarray(a) for a in _damped(want, lam))
    tinv, tW, tbsc = tpu_schur.prepare_factors(*(jnp.asarray(a) for a in (bp, Hll_d, bl, Hpl)),
                                               tsc, s.num_p)
    Hpp_p = assembly.damp(got[0], torch.tensor(lam, dtype=torch.float64))
    inv, W, bsc = schur.prepare_factors(got[1], assembly.damp(got[2], torch.tensor(
        lam, dtype=torch.float64)), got[3], got[4], sc, s.num_p)
    for g, w in ((W, tW), (bsc, tbsc)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-9)
    PB = 128
    Dt = tpu_schur.assemble_dense(jnp.asarray(Hpp_d), tW, jnp.asarray(Hpl), tsc, s.num_p, PB)
    Dp = schur.assemble_dense(Hpp_p, W, got[4], sc, s.num_p, PB)
    scale = float(np.abs(np.asarray(Dt)).max())
    np.testing.assert_allclose(Dp.numpy(), np.asarray(Dt), rtol=0, atol=1e-10 * scale)
    xp = torch.linalg.solve(Dp, torch.cat([bsc.reshape(-1),
                                           bsc.new_zeros(6 * (PB - s.num_p))]))[:6 * s.num_p]
    xl = schur.back_substitute(inv, got[3], got[4], xp.reshape(-1, 6), sc, s.num_l)
    xlt = tpu_schur.back_substitute(tinv, jnp.asarray(bl), jnp.asarray(Hpl),
                                    jnp.asarray(xp.reshape(-1, 6).numpy()), tsc, s.num_l)
    np.testing.assert_allclose(xl.numpy(), np.asarray(xlt), rtol=1e-9, atol=1e-12)


def test_aos_pcg_matches_cuba_tpu(aos_system):
    s, _tres, _pres, want, got, tsc, sc = aos_system
    lam = 1e-2
    Hpp_d, bp, Hll_d, bl, Hpl = (np.asarray(a) for a in _damped(want, lam))
    _inv, tW, tbsc = tpu_schur.prepare_factors(*(jnp.asarray(a) for a in (bp, Hll_d, bl, Hpl)),
                                               tsc, s.num_p)
    top = tpu_pcg.SchurOperator(jnp.asarray(Hpp_d), jnp.asarray(Hpl), tW, tsc.hpl_row,
                                tsc.hpl_col, s.num_p, s.num_l)
    xt, okt = tpu_pcg.pcg_solve(top, tbsc, 250, 1e-10)
    op = pcg.SchurOperator(torch.from_numpy(np.array(Hpp_d)), got[4],
                           torch.from_numpy(np.array(tW)), sc, s.num_p, s.num_l)
    x, ok, k = pcg.pcg_solve(op, torch.from_numpy(np.array(tbsc)), 250, 1e-10)
    assert bool(ok) and bool(okt) and 0 < k < 250
    np.testing.assert_allclose(x.numpy(), np.asarray(xt), rtol=1e-8, atol=1e-10)
    y = op.matvec(x)
    np.testing.assert_allclose(y.numpy(), np.asarray(top.matvec(jnp.asarray(x.numpy()))),
                               rtol=1e-9, atol=1e-9)


# ---------------------------------------------------------------------------
# LM trajectories on the AoS path
# ---------------------------------------------------------------------------


def _graph(pkg, syn, config, fix=None):
    ba = syn.build_graph(syn.generate(num_poses=10, num_landmarks=90, seed=7), config)
    if fix == "landmarks":
        for j in range(90):
            ba.landmark_vertex(j).fixed = True
    elif fix == "poses":
        for i in range(10):
            ba.pose_vertex(i).fixed = True
    ba.set_robust_kernels(pkg.RobustKernelType.HUBER, MONO_DELTA, pkg.EdgeType.MONOCULAR)
    ba.set_robust_kernels(pkg.RobustKernelType.HUBER, STEREO_DELTA, pkg.EdgeType.STEREO)
    return ba


def _optimize(ba, niters=6):
    ba.initialize()
    ba.optimize(niters)
    return np.array([s.chi2 for s in ba.batch_statistics()])


@pytest.mark.parametrize("solver", ["pcg", "band_cr", "dense_cholesky"])
def test_fp64_aos_trajectory_matches_xla_path(solver, monkeypatch):
    monkeypatch.setattr(rows, "plan_row_tables", lambda s, pad_blocks=0, lr=None: (None, None))
    tba = _graph(cuba_tpu, tpu_synthetic,
                 cuba_tpu.BAConfig(dtype=jnp.float64, mxu="off", solver=solver))
    want = _optimize(tba)
    ba = _graph(cuba_tpu_torch, synthetic,
                cuba_tpu_torch.BAConfig(dtype=torch.float64, solver=solver, device="cpu"))
    got = _optimize(ba)
    assert ba._engine.path == "aos" and ba._engine.solver == solver
    assert len(got) == len(want) >= 4
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[-1] < got[0]
    # per-edge chi² from the AoS residuals
    for e, te in zip(list(ba._mono_edges)[:20], list(tba._mono_edges)[:20]):
        np.testing.assert_allclose(ba.chi_squared(e), tba.chi_squared(te), rtol=1e-6,
                                   atol=1e-9)


def test_fp32_scattered_graph_takes_the_aos_path(monkeypatch):
    """tests/test_band_cr.py's scattered covisibility (an unordered photo
    collection: each landmark seen from four random poses) defeats
    cuba_tpu's window plans, and its AoS path runs it; the port's, with the
    planner made to find no plan, gives its trajectory."""
    monkeypatch.setattr(rows, "plan_row_tables", lambda s, pad_blocks=0, lr=None: (None, None))
    rng = np.random.default_rng(0)
    num_p, num_l = 200, 1600
    mp = np.concatenate([rng.choice(num_p, size=4, replace=False) for _ in range(num_l)])
    e = np.zeros((0,), np.int32)
    fp = np.zeros(num_p, bool)
    fp[0] = True
    s = tpu_structure.build_structure_from_arrays(
        np.tile(np.array([0.0, 0, 0, 1]), (num_p, 1)), rng.normal(size=(num_p, 3)) * 0.1,
        np.tile(np.array([500.0, 500, 320, 240, 0.1]), (num_p, 1)),
        rng.normal(size=(num_l, 3)) + np.array([0, 0, 5.0]), fp, np.zeros(num_l, bool),
        mp.astype(np.int32), np.repeat(np.arange(num_l, dtype=np.int32), 4),
        rng.normal(size=(mp.size, 2)) * 10 + np.array([320.0, 240]), np.ones(mp.size),
        e, e, np.zeros((0, 3)), np.zeros(0))
    teng = tpu_engine.BlockSolverEngine(s, KERNELS, cuba_tpu.BAConfig(dtype=jnp.float32,
                                                                       mxu="off"))
    plans, _ = mxu.plan_mxu(s, teng.pad_blocks, need_dense=True, wire_pack=False)
    r = teng.optimize(None, 5)
    want = np.asarray(r.chis)[:int(r.niters)]
    eng = engine.BlockSolverEngine(structure_from_numpy(s), KERNELS,
                                   cuba_tpu_torch.BAConfig(dtype=torch.float32, device="cpu"))
    got = eng.optimize(None, 5).chis
    assert not plans.ok and eng.path == "aos" and eng.solver == teng.solver
    n = min(len(got), len(want))
    assert n >= 3
    np.testing.assert_allclose(got[:n], want[:n], rtol=5e-3)
    assert got[n - 1] < got[0]


@pytest.mark.parametrize("fix", ["landmarks", "poses"])
def test_pose_only_and_landmark_only_descend(fix):
    tba = _graph(cuba_tpu, tpu_synthetic, cuba_tpu.BAConfig(dtype=jnp.float64, mxu="off"), fix)
    want = _optimize(tba, 4)
    ba = _graph(cuba_tpu_torch, synthetic,
                cuba_tpu_torch.BAConfig(dtype=torch.float64, device="cpu"), fix)
    got = _optimize(ba, 4)
    eng = ba._engine
    assert eng.path == "aos" and (eng.num_l if fix == "landmarks" else eng.num_p) == 0
    assert len(got) == len(want) >= 2
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[-1] < got[0]
