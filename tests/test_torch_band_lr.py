"""The band + Woodbury loop-closure solver (``solver="band_lr"``) against
cuba_tpu's, on the CPU.

- ``cr_solve_woodbury`` and ``ob_from_dense`` on tests/test_band_lr.py's
  random banded system with three out-of-band blocks: against cuba_tpu's in
  fp64 (1e-10) and fp32 (2e-4 of max |x|: both factor in exact fp32 with
  other summation orders, and the Woodbury correction amplifies the
  difference by the capacitance's conditioning), and against a dense numpy
  solve.
- LM trajectories on a loop-chord graph: the port's MXU route (the v2 band
  formation with its out-of-band gather) against cuba_tpu's XLA path in
  fp64 (1e-6) and its interpret path in fp32 (5e-3); the port's v1 route
  (the v2 gate closed) and its AoS route (the planner made to find no
  plan) against cuba_tpu's XLA path in fp64 (1e-6); and band_lr against dense_cholesky within the port (1e-6, as
  tests/test_band_lr.py holds cuba_tpu's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuba_tpu
import cuba_tpu_torch
from cuba_tpu.solver import band_cr as tpu_band_cr
from cuba_tpu.solver import engine as tpu_engine
from cuba_tpu.solver import structure as tpu_structure
from cuba_tpu_torch.interop import structure_from_numpy
from cuba_tpu_torch.solver import band_cr, engine, rows

torch.set_num_threads(1)

KERNELS = ((1, float(np.sqrt(5.991))), (1, float(np.sqrt(7.815))))


def _woodbury_system(dtype):
    """tests/test_band_lr.py's system: m = 3 CR blocks, three loop blocks."""
    rng = np.random.default_rng(42)
    B, m = band_cr.B, 3
    n = m * B
    Dg = rng.normal(size=(m, B, B))
    D = Dg @ np.swapaxes(Dg, 1, 2) + np.eye(B) * (2.0 * B)
    U = rng.normal(size=(m, B, B)) * 0.3
    U[-1] = 0
    A = np.zeros((n, n))
    for k in range(m):
        A[k * B:(k + 1) * B, k * B:(k + 1) * B] = D[k]
        if k + 1 < m:
            A[k * B:(k + 1) * B, (k + 1) * B:(k + 2) * B] = U[k]
            A[(k + 1) * B:(k + 2) * B, k * B:(k + 1) * B] = U[k].T
    obr = np.array([0, 2, 5])
    obc = np.array([m * 64 - 1, m * 64 - 3, m * 64 - 1])
    Vob = rng.normal(size=(3, 6, 6))
    for r, c, V in zip(obr, obc, Vob):
        A[r * 6:(r + 1) * 6, c * 6:(c + 1) * 6] += V
        A[c * 6:(c + 1) * 6, r * 6:(r + 1) * 6] += V.T
    b = rng.normal(size=n)
    J = np.unique(np.concatenate([obr, obc]))
    ob = (np.searchsorted(J, obr).astype(np.int32), np.searchsorted(J, obc).astype(np.int32),
          (J[:, None] * 6 + np.arange(6)).reshape(-1).astype(np.int32))
    cast = (lambda a: a.astype(dtype))
    return A, cast(D), cast(U), cast(b), cast(Vob), ob, obr, obc


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 2e-4)])
def test_woodbury_matches_cuba_tpu(dtype, tol):
    A, D, U, b, Vob, ob, _obr, _obc = _woodbury_system(dtype)
    x, ok, reads = band_cr.cr_solve_woodbury(*(torch.from_numpy(a) for a in (D, U, b, Vob)),
                                             *(torch.from_numpy(a) for a in ob), 1)
    xt, okt = tpu_band_cr.cr_solve_woodbury(*(jnp.asarray(a) for a in (D, U, b, Vob)),
                                            *(jnp.asarray(a) for a in ob), 1)
    assert bool(ok) and bool(okt) and x.dtype == torch.from_numpy(b).dtype
    assert reads == (1 if dtype == np.float32 else 0)  # the fp32 boost-retry decision
    scale = float(np.abs(np.asarray(xt)).max())
    np.testing.assert_allclose(x.numpy(), np.asarray(xt), rtol=0, atol=tol * scale)
    x_ref = np.linalg.solve(A, b.astype(np.float64))
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=0, atol=tol * scale)


def test_ob_from_dense_gathers_the_loop_blocks():
    A, _D, _U, _b, Vob, _ob, obr, obc = _woodbury_system(np.float64)
    got = band_cr.ob_from_dense(torch.from_numpy(A), obr, obc).numpy()
    np.testing.assert_array_equal(got, Vob)
    np.testing.assert_array_equal(got, np.asarray(tpu_band_cr.ob_from_dense(jnp.asarray(A),
                                                                             obr, obc)))


def test_woodbury_reports_a_failed_solve():
    _A, D, U, b, Vob, ob, _obr, _obc = _woodbury_system(np.float64)
    Vob = Vob.copy()
    Vob[0, 0, 0] = np.nan
    x, ok, _ = band_cr.cr_solve_woodbury(*(torch.from_numpy(a) for a in (D, U, b, Vob)),
                                         *(torch.from_numpy(a) for a in ob), 1)
    assert not bool(ok) and not x.any()


def _loop_structure():
    """tests/test_band_lr.py's loop graph: 200 poses of sequential
    covisibility plus four fold-resistant chords (PB 256: four CR blocks)."""
    rng = np.random.default_rng(3)
    num_p, num_l, chords = 200, 1800, 4
    qs = np.tile(np.array([0.0, 0, 0, 1]), (num_p, 1))
    ts = np.cumsum(rng.normal(0.1, 0.02, size=(num_p, 3)), axis=0)
    cams = np.tile(np.array([500.0, 500, 320, 240, 0.1]), (num_p, 1))
    Xws = rng.normal(size=(num_l, 3)) * 3 + np.array([0, 0, 6.0])
    fp = np.zeros(num_p, bool)
    fp[0] = True
    mp, ml = [], []
    for lm in range(num_l):
        base = (lm * num_p) // num_l
        for kk in range(3):
            mp.append(min(base + kk, num_p - 1))
            ml.append(lm)
    for c in range(chords):
        src = (c * 2 + 1) * num_p // (2 * chords + 1)
        for dst_frac in (3, 5):
            mp.append((src + dst_frac * num_p // 7) % num_p)
            ml.append((src * num_l) // num_p)
    mp = np.asarray(mp, np.int32)
    ml = np.asarray(ml, np.int32)
    mz = rng.normal(size=(len(mp), 2)) * 10 + np.array([320.0, 240])
    e = np.zeros((0,), np.int32)
    return tpu_structure.build_structure_from_arrays(
        qs, ts, cams, Xws, fp, np.zeros(num_l, bool), mp, ml, mz, np.ones(len(mp)),
        e, e, np.zeros((0, 3)), np.zeros(0))


@pytest.fixture(scope="module")
def loop_structure():
    return _loop_structure()


def _port_chis(s, dtype, solver="band_lr", niters=5):
    eng = engine.BlockSolverEngine(structure_from_numpy(s), KERNELS,
                                   cuba_tpu_torch.BAConfig(dtype=dtype, solver=solver,
                                                           device="cpu"))
    r = eng.optimize(None, niters)
    return eng, r.chis


def _tpu_chis(s, dtype, mxu_mode, solver="band_lr", niters=5):
    eng = tpu_engine.BlockSolverEngine(s, KERNELS, cuba_tpu.BAConfig(dtype=dtype, mxu=mxu_mode,
                                                                     solver=solver))
    r = eng.optimize(None, niters)
    return eng, np.asarray(r.chis)[:int(r.niters)]


def test_fp64_band_lr_trajectory_matches_xla_path(loop_structure):
    eng, got = _port_chis(loop_structure, torch.float64)
    assert eng.solver == "band_lr" and eng.path == "v2" and eng.plan.lr_nob > 0
    _, want = _tpu_chis(loop_structure, jnp.float64, "off")
    assert len(got) == len(want) >= 3
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[-1] < got[0]


def test_fp32_band_lr_trajectory_matches_interpret_path(loop_structure):
    eng, got = _port_chis(loop_structure, torch.float32, niters=3)
    teng, want = _tpu_chis(loop_structure, jnp.float32, "interpret", niters=3)
    assert teng.use_mxu and teng.mxu_plans.lr_nob == eng.plan.lr_nob
    n = min(len(got), len(want))
    assert n >= 2
    np.testing.assert_allclose(got[:n], want[:n], rtol=5e-3)
    # per attempt: the gain-ratio read and the fp32 boost-retry read
    r = eng.optimize(None, 1)
    assert r.host_reads == 2 * r.nattempts + 1


def test_fp64_band_lr_aos_path_matches_xla_path(loop_structure, monkeypatch):
    monkeypatch.setattr(rows, "plan_row_tables", lambda s, pad_blocks=0, lr=None: (None, None))
    eng, got = _port_chis(loop_structure, torch.float64)
    assert eng.solver == "band_lr" and eng.path == "aos" and eng.lr is not None
    _, want = _tpu_chis(loop_structure, jnp.float64, "off")
    assert len(got) == len(want) >= 3
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_fp64_band_lr_v1_path_matches_xla_path(loop_structure, monkeypatch):
    """With the v2 gate closed the planner takes the v1 formation, and
    band_lr slices its band and its loop blocks out of the dense matrix."""
    monkeypatch.setattr(rows, "_WG_MAX", 0)
    eng, got = _port_chis(loop_structure, torch.float64)
    assert eng.solver == "band_lr" and eng.path == "v1" and eng.plan.lr_nob == 0
    _, want = _tpu_chis(loop_structure, jnp.float64, "off")
    assert len(got) == len(want) >= 3
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_band_lr_matches_dense_solver(loop_structure):
    _, lr = _port_chis(loop_structure, torch.float64)
    _, dense = _port_chis(loop_structure, torch.float64, solver="dense_cholesky")
    n = min(len(lr), len(dense))
    assert n >= 3
    np.testing.assert_allclose(lr[:n], dense[:n], rtol=1e-6)
