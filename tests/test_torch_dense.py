"""The port's dense reduced solve against cuba_tpu's, on CPU.

- ``compact_to_dense``: the plain version against the Pallas kernel in
  interpret mode on two real plans (a 10-pose graph that ``solver="auto"``
  sends to the dense solver, and the 150-pose banded problem of
  tests/test_band_cr.py), with seeded compact tables.  A placement: bit for
  bit.  The CUDA kernel cannot run here; its index arithmetic over the
  planner's ``dense_table`` is walked in numpy and held to the plain version.
- The blocked triangular solves (``solver/trisolve.py``): the plain twins
  against cuba_tpu's Pallas kernels in interpret mode at n = 768 and 1536
  (fp32, both sides exact fp32 on the CPU, so within a few fp32 roundings of
  each other), and against numpy in fp64.
- ``cholesky_solve`` against cuba_tpu's: fp64 on both packages' CPU branch,
  fp32 through the blocked sweeps (cuba_tpu's Pallas path in interpret
  mode), a matrix that needs the diagonal-boost retry, and a negative
  definite one whose solve fails (ok False, x zeroed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuba_tpu.io import synthetic as tpu_synthetic
from cuba_tpu.ops import segmm as tpu_segmm
from cuba_tpu.solver import dense_cholesky as tpu_dense_cholesky
from cuba_tpu.solver import engine as tpu_engine
from cuba_tpu.solver import mxu
from cuba_tpu.solver import structure as tpu_structure
from cuba_tpu.solver import trisolve as tpu_trisolve
from cuba_tpu_torch.interop import structure_from_numpy
from cuba_tpu_torch.ops import segmm, walks
from cuba_tpu_torch.solver import dense_cholesky, rows, trisolve

torch.set_num_threads(1)

# (num_poses, num_landmarks, seed): "auto" resolves the first to the dense
# solver (one padded block of 128 poses), the second is banded (PB = 256)
PROBLEMS = {"dense_small": (10, 90, 7), "banded": (150, 1400, 2)}


@pytest.fixture(scope="module", params=sorted(PROBLEMS))
def dense_plan(request):
    num_p, num_l, seed = PROBLEMS[request.param]
    prob = tpu_synthetic.generate(num_poses=num_p, num_landmarks=num_l, seed=seed)
    fp = np.zeros(num_p, bool)
    fp[prob.fixed_poses] = True
    s = tpu_structure.build_structure_from_arrays(
        prob.qs, prob.ts, np.tile(prob.cam, (num_p, 1)), prob.Xws, fp, np.zeros(num_l, bool),
        prob.mono_p, prob.mono_l, prob.mono_z, prob.mono_w,
        prob.stereo_p, prob.stereo_l, prob.stereo_z, prob.stereo_w,
    )
    PB = tpu_engine._pad_blocks(s.num_p)
    plans, consts = mxu.plan_mxu(s, PB, need_dense=True, wire_pack=False)
    assert plans.ok and plans.v2
    plan, rc = rows.plan_rows(structure_from_numpy(s), "cpu", torch.float32, pad_blocks=PB,
                              dense=True)
    rng = np.random.default_rng(13)
    gT = rng.standard_normal((36, PB // 64 * plan.wg)).astype(np.float32)
    dbT = rng.standard_normal((36, PB)).astype(np.float32)
    return s.num_p, PB, plans, consts, plan, rc, gT, dbT


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy (jax arrays are read-only)


def test_compact_to_dense_plain_matches_pallas(dense_plan):
    _P, PB, plans, consts, plan, rc, gT, dbT = dense_plan
    got = segmm.compact_to_dense(_t(gT), rc.iru, rc.icu, _t(dbT), rc.occ2, PB,
                                 plan.wg).numpy()
    want = np.asarray(tpu_segmm.compact_to_dense(
        jnp.asarray(gT), jnp.asarray(consts.iru), jnp.asarray(consts.icu), jnp.asarray(dbT),
        jnp.asarray(consts.occ2), PB, plans.wg, interpret=True))
    assert got.shape == want.shape == (6 * PB, 6 * PB)
    # a placement: the Pallas kernel's exact one-hot selections give the
    # same values, db - up on the diagonal in one rounding on both sides
    np.testing.assert_array_equal(got, want)


def test_dense_table_walk_matches_plain(dense_plan):
    """compact_to_dense's kernel index arithmetic over the placement table
    (``walks.compact_to_dense_walk``: its blocks, threads and float4
    stores) gives the plain version bit for bit, each output float4 written
    exactly once."""
    _P, PB, _plans, _consts, plan, rc, gT, dbT = dense_plan
    got, writes = walks.compact_to_dense_walk(gT, rc.dense_table.numpy(), dbT,
                                              rc.occ2.numpy(), PB)
    assert np.all(writes == 1)
    plain = segmm.compact_to_dense_plain(_t(gT), rc.iru, rc.icu, _t(dbT), rc.occ2, PB,
                                         plan.wg).numpy()
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("PB,grid", [(128, [128, 1]), (256, [256, 2]), (1408, [1408, 11])])
def test_compact_to_dense_launch_rule(PB, grid):
    """A block per (pose row, column tile of 128 pose blocks): kitti07's
    PB 256 and the kitti00 loop graph's PB 1408 (1408 x 11 blocks); the
    [6, 768] strip and 128 table entries fit the 48 KB of static shared
    memory."""
    launch = segmm.compact_to_dense_launch(PB)
    assert launch == dict(grid=grid, threads=192, smem=4 * (6 * 768 + 128))
    assert launch["smem"] <= 48 * 1024
    # the strip's 1152 float4 and 4608 placements split evenly over the threads
    assert 6 * 768 // 4 % launch["threads"] == 0 and 36 * 128 % launch["threads"] == 0


@pytest.mark.parametrize("case", ["gT narrower than M*Wg", "dbT narrower than PB",
                                  "occ2 shorter than the tiles"])
def test_compact_to_dense_refuses_input_that_does_not_fit(dense_plan, case):
    _P, PB, _plans, _consts, plan, rc, gT, dbT = dense_plan
    args = [_t(gT), rc.iru, rc.icu, _t(dbT), rc.occ2]
    k = {"gT": 0, "dbT": 3, "occ2": 4}[case.split()[0]]
    args[k] = args[k][..., :-1].contiguous()
    with pytest.raises(ValueError, match="do not fit"):
        segmm.compact_to_dense(*args, PB, plan.wg)


def test_dense_formation_matches_schur_dense_mxu(dense_plan):
    num_p, PB, plans, consts, plan, rc, _gT, _dbT = dense_plan
    rng = np.random.default_rng(5)
    H = plan.hpl_pad
    W = (rng.standard_normal((18, H)) * 0.3).astype(np.float32)
    G = (rng.standard_normal((18, H)) * 0.3).astype(np.float32)
    HppT = rng.standard_normal((42, num_p)).astype(np.float32)
    lam = np.float32(1e-3)
    mc = jax.tree_util.tree_map(jnp.asarray, consts)
    want = mxu.schur_dense_mxu(jnp.asarray(HppT), jnp.asarray(W), jnp.asarray(G), lam,
                               num_p, PB, plans, mc, jnp.float32, interpret=True)
    got = rows.schur_dense(_t(HppT), _t(W), _t(G), torch.tensor(lam), num_p, plan, rc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the blocked triangular solves
# ---------------------------------------------------------------------------

# each entry within this share of the largest |entry| of cuba_tpu's result:
# both sides sum in exact fp32, in other orders, through up to six stripes
SWEEP_RTOL = 2e-6


def _spd(n, seed, spread=0.0, lam_min=None):
    """A seeded SPD matrix (or, with ``lam_min`` < 0, a symmetric one with
    that smallest eigenvalue), rows and columns scaled over 10^+-spread."""
    rng = np.random.default_rng(seed)
    if lam_min is None:
        G = rng.standard_normal((n, n))
        A = G @ G.T / n + np.eye(n)
    else:
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        lam = rng.uniform(0.5, 1.5, n)
        lam[0] = lam_min
        A = (Q * lam) @ Q.T
    if spread:
        D = 10 ** rng.uniform(-spread, spread, n)
        A = A * D[:, None] * D[None, :]
    return A


@pytest.fixture(scope="module", params=[768, 1536])
def factor(request):
    n = request.param
    A = _spd(n, n)
    L64 = np.linalg.cholesky(A)
    b64 = np.random.default_rng(n + 1).standard_normal(n)
    L, b = L64.astype(np.float32), b64.astype(np.float32)
    invd = np.asarray(tpu_trisolve.prepare(jnp.asarray(L), interpret=True))
    return A, L64, b64, L, b, invd


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= SWEEP_RTOL * np.abs(want).max()


def test_extract_diag_blocks_matches_pallas(factor):
    _A, L64, _b64, L, _b, _invd = factor
    got = trisolve.extract_diag_blocks(_t(L)).numpy()
    want = np.asarray(tpu_trisolve._extract_diag_blocks(jnp.asarray(L), trisolve.BLOCK, True))
    np.testing.assert_array_equal(got, want)  # a copy
    K, B = L.shape[0] // 256, 256
    ref = np.stack([L64[k * B:(k + 1) * B, k * B:(k + 1) * B] for k in range(K)])
    np.testing.assert_array_equal(trisolve.extract_diag_blocks(_t(L64)).numpy(), ref)


def test_tri_inv_blocks_matches_cuba_tpu(factor):
    _A, L64, _b64, L, _b, invd = factor
    Ld = trisolve.extract_diag_blocks(_t(L))
    _close(trisolve.tri_inv_blocks(Ld).numpy(), invd)
    Ld64 = trisolve.extract_diag_blocks(_t(L64))
    inv64 = trisolve.tri_inv_blocks(Ld64).numpy()
    eye = np.broadcast_to(np.eye(256), inv64.shape)
    assert np.abs(inv64 @ Ld64.numpy() - eye).max() < 1e-12


def test_solve_lower_matches_pallas(factor):
    _A, L64, b64, L, b, invd = factor
    got = trisolve.solve_lower(_t(L), _t(invd), _t(b)).numpy()
    _close(got, tpu_trisolve.solve_lower(jnp.asarray(L), jnp.asarray(invd), jnp.asarray(b),
                                         interpret=True))
    y64 = trisolve.solve_lower(_t(L64), trisolve.prepare(_t(L64)), _t(b64)).numpy()
    np.testing.assert_allclose(y64, np.linalg.solve(L64, b64), rtol=0, atol=1e-12)


def test_solve_upper_matches_pallas(factor):
    _A, L64, b64, L, b, invd = factor
    got = trisolve.solve_upper(_t(L), _t(invd), _t(b)).numpy()
    _close(got, tpu_trisolve.solve_upper(jnp.asarray(L), jnp.asarray(invd), jnp.asarray(b),
                                         interpret=True))
    x64 = trisolve.solve_upper(_t(L64), trisolve.prepare(_t(L64)), _t(b64)).numpy()
    np.testing.assert_allclose(x64, np.linalg.solve(L64.T, b64), rtol=0, atol=1e-12)


def test_matvec_matches_pallas(factor):
    A, _L64, b64, _L, b, _invd = factor
    A32 = A.astype(np.float32)
    got = trisolve.matvec(_t(A32), _t(b)).numpy()
    want = np.asarray(tpu_trisolve.matvec(jnp.asarray(A32), jnp.asarray(b), interpret=True))
    # each row within 1e-6 of its sum of |A_ij x_j| (fp32 sums in two orders)
    assert np.all(np.abs(got - want) <= 1e-6 * (np.abs(A32) @ np.abs(b)))
    got64 = trisolve.matvec(_t(A), _t(b64)).numpy()
    assert np.all(np.abs(got64 - A @ b64) <= 1e-14 * (np.abs(A) @ np.abs(b64)))


@pytest.mark.parametrize("name", ["solve_lower", "solve_upper", "extract_diag_blocks"])
def test_sweep_kernel_walk_matches_plain(factor, name):
    """The kernels of csrc/trisolve.cu walked in numpy over fp64 memory
    give the plain versions: each sweep's one launch, its tiles in ticket
    order (``walks.solve_lower_walk``, ``walks.solve_upper_walk``), to
    1e-12 of max |result|; the copy's float4 grid bit for bit."""
    _A, L64, b64, _L, _b, _invd = factor
    invd = trisolve.prepare(_t(L64)).numpy()
    if name == "extract_diag_blocks":  # the float4 grid of the CUDA copy
        got, writes = walks.extract_diag_walk(L64)
        assert np.all(writes == 1)
        np.testing.assert_array_equal(got, trisolve.extract_diag_blocks_plain(_t(L64)).numpy())
        return
    walk = getattr(walks, name + "_walk")  # one launch of solve_lower_kernel / solve_upper_kernel
    out = walk(L64, invd, b64)
    want = getattr(trisolve, name + "_plain")(_t(L64), _t(invd), _t(b64)).numpy()
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_solve_lower_walk_matches_pallas(factor):
    """The forward sweep kernel's order (``walks.solve_lower_walk``, each
    fp32 FMA rounded once) against cuba_tpu's Pallas ``solve_lower`` in
    interpret mode: both exact fp32 in other orders (SWEEP_RTOL)."""
    _A, _L64, _b64, L, b, invd = factor
    got = walks.solve_lower_walk(L, invd, b)
    assert got.dtype == np.float32
    _close(got, tpu_trisolve.solve_lower(jnp.asarray(L), jnp.asarray(invd), jnp.asarray(b),
                                         interpret=True))


@pytest.mark.parametrize("n,dtype,want", [(1536, torch.float32, True),
                                          (768, torch.float32, True),
                                          (256, torch.float32, False),
                                          (1000, torch.float32, False),
                                          (1536, torch.float64, False)])
def test_usable_keeps_the_shape_conditions(n, dtype, want):
    assert trisolve.usable(n, dtype) is want
    assert tpu_trisolve.usable(n, jnp.float32 if dtype == torch.float32 else jnp.float64) \
        is want


# ---------------------------------------------------------------------------
# cholesky_solve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["fp64", "fp32 blocked", "boost retry", "negative definite"])
def test_cholesky_solve_matches_cuba_tpu(case):
    n = 768
    refine = 0 if case == "fp64" else 1
    if case == "fp64":
        A, dt = _spd(n, 3, spread=3), np.float64  # 1e12 dynamic range: equilibration
    elif case == "fp32 blocked":
        A, dt = _spd(n, 3, spread=2), np.float32
    elif case == "boost retry":
        # indefinite by 5e-5: the first factorisation and the 1e-5 boost
        # fail, the 3.2e-4 boost holds
        A, dt = _spd(n, 5, spread=2, lam_min=-5e-5), np.float32
    else:
        A, dt = -_spd(n, 7), np.float32
    A = A.astype(dt)
    b = np.random.default_rng(4).standard_normal(n).astype(dt)
    blocked = dt == np.float32
    x_t, ok_t = tpu_dense_cholesky.cholesky_solve(jnp.asarray(A), jnp.asarray(b), refine,
                                                  use_pallas=blocked, interpret=True)
    x, ok, reads = dense_cholesky.cholesky_solve(_t(A), _t(b), refine, use_kernels=blocked)
    x_t = np.asarray(x_t)
    assert bool(ok) == bool(ok_t) == (case != "negative definite")
    # one host read per boost decision in fp32: the retry stops at success
    # or after four boosts (whose last factor needs no read)
    assert reads == {"fp64": 0, "fp32 blocked": 1, "boost retry": 3,
                     "negative definite": 4}[case]
    if not bool(ok):
        assert not x.any() and not x_t.any()
        return
    # fp64: the same algorithm in other fp64 sums; fp32: a few roundings
    # through the sweeps; boosted: those amplified by the shifted system's
    # condition number (~6e3)
    rtol = {"fp64": 1e-12, "fp32 blocked": 1e-5, "boost retry": 5e-4}[case]
    assert np.abs(x.numpy() - x_t).max() <= rtol * np.abs(x_t).max()
    if case == "fp64":
        xe = np.linalg.solve(A, b)
        assert np.abs(x.numpy() - xe).max() <= 1e-9 * np.abs(xe).max()


def test_cholesky_solve_keeps_the_last_finite_iterate(monkeypatch):
    """A refinement sweep that overflows is dropped, not returned: with a
    residual that goes non-finite, the refined solve keeps the first
    solve's x and stays ok."""
    n = 512
    A = _spd(n, 9).astype(np.float32)
    b = np.random.default_rng(10).standard_normal(n).astype(np.float32)
    x1, ok1, _ = dense_cholesky.cholesky_solve(_t(A), _t(b), 0, use_kernels=True)
    monkeypatch.setattr(trisolve, "matvec", lambda A_, v: torch.full_like(v, float("inf")))
    x2, ok2, _ = dense_cholesky.cholesky_solve(_t(A), _t(b), 2, use_kernels=True)
    assert bool(ok1) and bool(ok2)
    np.testing.assert_array_equal(x2.numpy(), x1.numpy())
