"""The port's cyclic-reduction band solver against cuba_tpu's
(solver/band_cr.py), on the same seeded block-tridiagonal systems.

fp64: factor + solve, matvec and cr_solve agree with cuba_tpu's to 1e-10
relative (the same algorithm in another order of fp64 sums).  fp32 with one
refinement sweep: within 1e-4 of the fp64 dense solution, the bar of
tests/test_band_cr.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuba_tpu.solver import band_cr as tpu_band_cr
from cuba_tpu_torch.solver import band_cr

torch.set_num_threads(1)

B = band_cr.B
assert B == tpu_band_cr.B


def _banded_system(m, seed, couple=0.3, dtype=np.float64):
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((m, B, B)) * couple
    U[m - 1] = 0
    D = rng.standard_normal((m, B, B))
    D = np.einsum("mij,mkj->mik", D, D) + np.eye(B) * B
    b = rng.standard_normal(m * B)
    return D.astype(dtype), U.astype(dtype), b.astype(dtype)


def _dense_of(D, U):
    m = D.shape[0]
    A = np.zeros((m * B, m * B), D.dtype)
    for k in range(m):
        A[k * B:(k + 1) * B, k * B:(k + 1) * B] = D[k]
        if k + 1 < m:
            A[k * B:(k + 1) * B, (k + 1) * B:(k + 2) * B] = U[k]
            A[(k + 1) * B:(k + 2) * B, k * B:(k + 1) * B] = U[k].T
    return A


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("m", [2, 3, 5, 8])
def test_cr_solve_matches_cuba_tpu_fp64(m):
    D, U, b = _banded_system(m, seed=m)
    want, want_ok = tpu_band_cr.cr_solve(jnp.asarray(D), jnp.asarray(U), jnp.asarray(b))
    got, ok, reads = band_cr.cr_solve(_t(D), _t(U), _t(b))
    assert bool(ok) and bool(want_ok) and reads == 0  # no boost test in fp64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-13)
    x_ref = np.linalg.solve(_dense_of(D, U), b)
    np.testing.assert_allclose(got.numpy(), x_ref, rtol=1e-9, atol=1e-9)
    # the factor itself, and a multi-RHS solve through it
    levels, base = band_cr.factor(_t(D), _t(U))
    tlevels, tbase = tpu_band_cr.factor(jnp.asarray(D), jnp.asarray(U))
    assert len(levels) == len(tlevels)
    np.testing.assert_allclose(base.numpy(), np.asarray(tbase), rtol=1e-10, atol=1e-14)
    for lv, tlv in zip(levels, tlevels):
        for a, c in zip(lv, tlv):
            np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-10, atol=1e-14)
    rhs = np.random.default_rng(m + 100).standard_normal((m * B, 3))
    np.testing.assert_allclose(
        band_cr.solve(levels, base, _t(rhs)).numpy(),
        np.asarray(tpu_band_cr.solve(tlevels, tbase, jnp.asarray(rhs))),
        rtol=1e-10, atol=1e-13)


def test_cr_matvec_matches_cuba_tpu():
    D, U, _b = _banded_system(7, seed=1)
    x = np.random.default_rng(2).standard_normal(7 * B)
    got = band_cr.matvec(_t(D), _t(U), _t(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(tpu_band_cr.matvec(jnp.asarray(D), jnp.asarray(U), jnp.asarray(x))),
        rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got, _dense_of(D, U) @ x, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("inv", ["rs", "chol"])
def test_cr_fp32_with_refinement(inv):
    D, U, b = _banded_system(8, seed=3, dtype=np.float32)
    x_ref = np.linalg.solve(_dense_of(D, U).astype(np.float64), b.astype(np.float64))
    fn = {"rs": band_cr._inv_spd_rs, "chol": band_cr._inv_spd_chol}[inv]
    got, ok, reads = band_cr.cr_solve(_t(D), _t(U), _t(b), refinement_steps=1, inv=fn)
    assert bool(ok) and reads == 1  # the fp32 boost test reads the host once
    err = np.abs(got.numpy() - x_ref).max() / np.abs(x_ref).max()
    assert err < 1e-4, err
    want, _ = tpu_band_cr.cr_solve(jnp.asarray(D), jnp.asarray(U), jnp.asarray(b),
                                   refinement_steps=1)
    assert np.abs(got.numpy() - np.asarray(want)).max() / np.abs(x_ref).max() < 1e-4


def test_inverses_agree_with_cuba_tpu():
    rng = np.random.default_rng(7)
    A = rng.standard_normal((3, B, B))
    M = np.einsum("mij,mkj->mik", A, A) + np.eye(B) * B
    want = np.asarray(tpu_band_cr._inv_spd_rs(jnp.asarray(M)))
    for fn in (band_cr._inv_spd_rs, band_cr._inv_spd_chol):
        np.testing.assert_allclose(fn(_t(M)).numpy(), want, rtol=1e-10, atol=1e-14)


def test_cholesky_failure_gives_nan():
    """torch's cholesky_ex reports a failure in ``info`` where JAX's
    cholesky gives NaN; the port turns it into NaN, per matrix."""
    M = np.stack([np.eye(48), -np.eye(48)]).astype(np.float32)
    inv = band_cr._inv_spd_chol(_t(M)).numpy()
    np.testing.assert_array_equal(inv[0], np.eye(48, dtype=np.float32))
    assert np.isnan(inv[1]).all()


def test_cr_indefinite_reports_not_ok():
    # a strongly negative-definite middle block: non-finite even after the
    # boost retry, so the step is rejected and x comes back as zeros
    D = np.stack([np.eye(B), np.zeros((B, B)), np.eye(B)])
    D[1] -= 1e3 * np.eye(B)
    U = np.zeros((3, B, B))
    b = np.ones(3 * B)
    args = [np.asarray(a, np.float32) for a in (D, U, b)]
    x, ok, reads = band_cr.cr_solve(*(_t(a) for a in args))
    want_x, want_ok = tpu_band_cr.cr_solve(*(jnp.asarray(a) for a in args))
    assert not bool(ok) and not bool(want_ok)
    assert reads == 1
    np.testing.assert_array_equal(x.numpy(), np.asarray(want_x))
    assert np.all(x.numpy() == 0)


@pytest.mark.parametrize("r,c,pb,m", [
    (np.arange(99), np.arange(1, 100), 128, 2),  # neighbours only
    ([0, 0], [1, 99], 128, 2),  # adjacent CR tiles, |r - c| > 64
    ([0, 0], [1, 190], 192, 0),  # two tiles apart
    ([0], [1], 64, 0),  # m < 2
    ([0], [1], 100, 0),  # padding not a whole CR block
])
def test_certify(r, c, pb, m):
    assert band_cr.certify(np.asarray(r), np.asarray(c), pb) == m
    assert tpu_band_cr.certify(np.asarray(r), np.asarray(c), pb) == m
    mm, ob = band_cr.certify_lr(np.asarray(r), np.asarray(c), pb)
    tm, tob = tpu_band_cr.certify_lr(np.asarray(r), np.asarray(c), pb)
    assert mm == tm
    np.testing.assert_array_equal(ob, tob)


def test_from_dense_matches_cuba_tpu():
    D, U, _b = _banded_system(3, seed=9)
    A = _dense_of(D, U)
    Dp, Up = band_cr.from_dense(_t(A), 3)
    Dt, Ut = tpu_band_cr.from_dense(jnp.asarray(A), 3)
    np.testing.assert_array_equal(Dp.numpy(), np.asarray(Dt))
    np.testing.assert_array_equal(Up.numpy(), np.asarray(Ut))
