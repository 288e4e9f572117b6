"""The solve stages the port's tools time, against ``cuba_tpu`` on the CPU.

``profile_crsolve``'s seeded band and its stages, and ``profile_formation``'s
CR stages, against ``cuba_tpu.solver.band_cr``'s ``factor``,
``_factor_equilibrated`` and ``cr_solve`` in fp64 to 1e-10, the two
diagonal-block inverses to 1e-8 of each other; ``bench_pcg_band_mc``'s
PCG (its step count and solution) against ``cuba_tpu``'s
``mxu.pcg_solve_rows(..., with_iters=True)`` on the same inputs (fp32:
``cuba_tpu``'s rows PCG has no fp64);
``perf_probe_solve``'s solve against ``cuba_tpu``'s
``dense_cholesky.cholesky_solve`` in fp64 to 1e-10; ``bench_pcg_band_mc``'s
model; and ``make_bal_fixture`` against the committed fixtures and the
JAX package's script.
"""

import gzip
import hashlib
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuba_tpu.config import BAConfig as TpuConfig
from cuba_tpu.io import synthetic as tpu_synthetic
from cuba_tpu.ops import robust as tpu_robust
from cuba_tpu.solver import band_cr as tpu_band_cr
from cuba_tpu.solver import dense_cholesky as tpu_dense
from cuba_tpu.solver import mxu
from cuba_tpu.solver.engine import BlockSolverEngine as TpuEngine
from cuba_tpu.solver.structure import build_structure_from_arrays
from cuba_tpu_torch.config import BAConfig
from cuba_tpu_torch.interop import structure_from_numpy
from cuba_tpu_torch.solver import band_cr
from cuba_tpu_torch.solver.engine import BlockSolverEngine
from cuba_tpu_torch.tools import (bench_pcg_band_mc, graphs, make_bal_fixture,
                                  perf_probe_solve, profile_crsolve, profile_formation, roofline)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(t):
    return t.detach().double().numpy()


@pytest.fixture(scope="module", params=[2, 3])
def band(request):
    """profile_crsolve's seeded band at m = 2 and 3 (SPD there), fp64."""
    return profile_crsolve.band(request.param, "cpu", F64)


def test_seeded_band_is_the_jax_tools(band):
    """The band's numbers are the JAX tool's: ``default_rng(0)``'s draws in
    its order, in fp32."""
    D, U, b = band
    m, B = D.shape[0], band_cr.B
    rng = np.random.default_rng(0)
    Dg = rng.normal(size=(m, B, B)).astype(np.float32)
    want_D = (Dg @ np.swapaxes(Dg, 1, 2) / B + np.eye(B) * 2.0).astype(np.float32)
    assert np.array_equal(_np(D), want_D.astype(np.float64))
    assert float(U[-1].abs().max()) == 0.0 and b.shape == (m * B,)


def test_factor_matches_cuba_tpu_fp64(band):
    D, U, b = band
    levels, base = band_cr.factor(D, U)
    tlevels, tbase = tpu_band_cr.factor(jnp.asarray(_np(D)), jnp.asarray(_np(U)))
    np.testing.assert_allclose(_np(base), np.asarray(tbase), rtol=1e-10, atol=1e-12)
    x = band_cr.solve(levels, base, b)
    want = tpu_band_cr.solve(tlevels, tbase, jnp.asarray(_np(b)))
    np.testing.assert_allclose(_np(x), np.asarray(want), rtol=1e-10, atol=1e-12)


def test_crsolve_stages_match_cuba_tpu_fp64(band):
    """Every stage of ``profile_crsolve`` computes what the same calls of
    ``cuba_tpu`` compute: the equilibrated factor with one and two
    solves, cr_solve at refine 0, and the multi-RHS solves."""
    D, U, b = band
    jD, jU, jb = (jnp.asarray(_np(t)) for t in (D, U, b))
    sw = tpu_band_cr._factor_equilibrated(jD, jU)
    x1 = sw(jb)
    x2 = x1 + sw(jb + x1 * 1e-30)
    scale = 1.0 + jnp.arange(96, dtype=jnp.float64) * 1e-3
    want = {"equilibrate + boost + factor + 1 solve": x1,
            "equilibrate + boost + factor + 2 solves": x2,
            "cr_solve refine=0": tpu_band_cr.cr_solve(jD, jU, jb, 0)[0],
            "factor + solve 96 RHS": sw(jb[:, None] * scale[None, :])}
    stages = profile_crsolve.stages(D, U, b)
    assert set(want) < set(stages)
    for label, w in want.items():
        got = stages[label]()
        got = got[0] if isinstance(got, tuple) else got
        np.testing.assert_allclose(_np(got), np.asarray(w), rtol=1e-10, atol=1e-12,
                                   err_msg=label)


@pytest.mark.parametrize("refine", [0, 1, 2])
def test_formation_cr_stages_match_cuba_tpu_fp64(band, refine):
    D, U, b = band
    got = profile_formation.cr_stages(D, U, b)[f"cr_solve refine={refine}"]()
    want, want_ok = tpu_band_cr.cr_solve(*(jnp.asarray(_np(t)) for t in (D, U, b)), refine)
    assert bool(got[1]) and bool(want_ok)
    np.testing.assert_allclose(_np(got[0]), np.asarray(want), rtol=1e-10, atol=1e-12)


def test_both_inverses_agree_fp64(band):
    """The factor and the refine-1 solve with ``_inv_spd_chol`` against
    ``_inv_spd_rs`` to 1e-8; ``cr_check``'s residuals fall with refinement."""
    D, U, b = band
    st = profile_formation.cr_stages(D, U, b)
    rs, chol = st["cr factor (_inv_spd_rs)"](), st["cr factor (_inv_spd_chol)"]()
    np.testing.assert_allclose(_np(chol[1]), _np(rs[1]), rtol=1e-8, atol=1e-10)
    chk = profile_formation.cr_check(D, U, b)
    assert chk["ok"] and chk["inverses"] < 1e-8 and chk["reads"] == 0
    assert chk["residual"][0] < 1e-12 and chk["residual"][1] <= chk["residual"][0] * 10


def test_seeded_band_at_m22_is_not_spd():
    """At the JAX tool's m = 22 the seeded band is indefinite: cr_solve
    rejects it (ok False), which ``profile_crsolve`` reports, not hides."""
    D, U, b = profile_crsolve.band(profile_crsolve.M, "cpu", torch.float32)
    _x, ok, reads = band_cr.cr_solve(D, U, b, 0)
    assert not bool(ok) and reads == 1


KERNELS = ((tpu_robust.HUBER, float(np.sqrt(5.991))), (tpu_robust.HUBER, float(np.sqrt(7.815))))


# cuba_tpu's rows PCG runs in fp32 only (its one-hot dot splits fp32
# values into bf16 triples by bit masks), so the comparison is fp32, at
# the JAX tool's practical inexact-Newton tolerance (1e-4: fp32 reaches
# no 1e-10), x within PCG_XTOL of max |x| (two fp32 sum orders through
# the CG recurrence)
PCG_TOL = 1e-4
PCG_XTOL = 1e-3


def test_pcg_matches_cuba_tpu_steps():
    """bench_pcg_band_mc's PCG on the port's first damped attempt, and
    ``cuba_tpu``'s ``mxu.pcg_solve_rows(..., with_iters=True)`` on the same
    arrays over its own row plans (the Pallas kernels in interpret mode):
    the same step count and x within PCG_XTOL of max |x|."""
    prob = tpu_synthetic.generate(num_poses=10, num_landmarks=90, seed=5)
    fp = np.zeros(10, bool)
    fp[prob.fixed_poses] = True
    s = build_structure_from_arrays(
        prob.qs, prob.ts, np.tile(prob.cam, (10, 1)), prob.Xws, fp, np.zeros(90, bool),
        prob.mono_p, prob.mono_l, prob.mono_z, prob.mono_w,
        prob.stereo_p, prob.stereo_l, prob.stereo_z, prob.stereo_w)
    tpu = TpuEngine(s, KERNELS, TpuConfig(dtype=jnp.float32, mxu="interpret", solver="pcg"))
    assert tpu.use_rows
    port = BlockSolverEngine(structure_from_numpy(s), KERNELS,
                             BAConfig(dtype=torch.float32, solver="pcg", device="cpu"))
    HppT, HplT, lam, W, _bsc = bench_pcg_band_mc.attempt_of(port)
    cap = port.config.pcg_max_iterations
    x, ok, k = bench_pcg_band_mc.pcg(port, HppT, HplT, W, lam, PCG_TOL)
    want_x, want_ok, want_k = mxu.pcg_solve_rows(
        *(jnp.asarray(t.numpy()) for t in (HppT, HplT, W, lam, HppT[36:42])), tpu.num_p,
        tpu.num_l, tpu.mxu_plans, tpu.consts.mxu, cap, PCG_TOL, interpret=True,
        with_iters=True)
    assert bool(ok) and bool(want_ok) and k == int(want_k) and 1 < k < cap
    want_x = np.asarray(want_x, np.float64)
    np.testing.assert_allclose(_np(x), want_x, rtol=0, atol=PCG_XTOL * np.abs(want_x).max())


def test_pcg_band_mc_measures_at_the_jax_tools_lambda(monkeypatch):
    """bench_pcg_band_mc's measurement on its own small kitti00 loop graph
    (130 P / 3,000 L, band_cr): the attempt is damped at λ = 1e-3, the JAX
    tool's ``lam0`` (not the engine's τ·max diag), and its PCG step count
    and convergence are ``cuba_tpu``'s ``mxu.pcg_solve_rows`` at that λ on
    the same arrays (the Pallas kernels in interpret mode)."""
    monkeypatch.setattr(roofline, "stage_times",
                        lambda fns, device, reps: {k: (1.0, None, []) for k in fns})
    monkeypatch.setattr(bench_pcg_band_mc, "t_lat_ms", lambda engine, group: 0.01)
    params = dict(graphs.KITTI00_LOOP, num_poses=130, num_landmarks=3000)
    port = bench_pcg_band_mc.engine_of(params, "cpu", torch.float32)
    m = bench_pcg_band_mc.measure(port, 1, PCG_TOL, "cpu")
    assert m["lam"] == float(np.float32(1e-3))
    prob = tpu_synthetic.generate(**params)
    fp = np.zeros(130, bool)
    fp[prob.fixed_poses] = True
    s = build_structure_from_arrays(
        prob.qs, prob.ts, np.tile(prob.cam, (130, 1)), prob.Xws, fp, np.zeros(3000, bool),
        prob.mono_p, prob.mono_l, prob.mono_z, prob.mono_w,
        prob.stereo_p, prob.stereo_l, prob.stereo_z, prob.stereo_w)
    tpu = TpuEngine(s, KERNELS, TpuConfig(dtype=jnp.float32, mxu="interpret", solver="band_cr"))
    assert tpu.use_rows and (port.solver, tpu.solver) == ("band_cr", "band_cr")
    HppT, HplT, lam, W, _bsc = bench_pcg_band_mc.attempt_of(port)
    # the port pads its slot tables for the card, cuba_tpu for its tile
    # plans: the extra slots are zero on both sides
    H = tpu.mxu_plans.hpl_pad
    HplT, W = (torch.nn.functional.pad(t, (0, H - t.shape[1])) for t in (HplT, W))
    _x, want_ok, want_k = mxu.pcg_solve_rows(
        *(jnp.asarray(t.numpy()) for t in (HppT, HplT, W, lam, HppT[36:42])), tpu.num_p,
        tpu.num_l, tpu.mxu_plans, tpu.consts.mxu, port.config.pcg_max_iterations, PCG_TOL,
        interpret=True, with_iters=True)
    assert np.float32(lam) == np.float32(1e-3)
    assert (m["n_cg"], m["converged"]) == (int(want_k), bool(want_ok))


def test_pcg_band_model():
    """band(S) = t_form / S + t_band, pcg(S) = (t_pcg - n t_lat) / S + n
    t_lat, and the first S where PCG is below the band."""
    table, cross = bench_pcg_band_mc.model(8.0, 2.0, 40.0, 100, 0.05)
    assert table[0] == (1, 10.0, 40.0)
    assert table[3] == (8, 3.0, 35.0 / 8 + 5.0)
    assert cross is None
    table, cross = bench_pcg_band_mc.model(8.0, 2.0, 40.0, 10, 0.05)
    assert cross == 32 and all(p >= b for S, b, p in table if S < 32)


@pytest.mark.parametrize("accepted", [True, False])
def test_pcg_band_mc_reports_no_crossover_on_a_rejected_band(monkeypatch, capsys, accepted):
    """Where ``cr_solve`` rejects the band bench_pcg_band_mc times, t_band
    is the time of a rejected solve: the measurement says so and reports
    no crossover, whatever the model gives; where it accepts it, the
    model's crossover stands."""
    monkeypatch.setattr(roofline, "stage_times",
                        lambda fns, device, reps: {k: (1.0, None, []) for k in fns})
    monkeypatch.setattr(bench_pcg_band_mc, "t_lat_ms", lambda engine, group: 0.01)
    monkeypatch.setattr(bench_pcg_band_mc, "model", lambda *a: ([(1, 2.0, 1.0)], 1))
    monkeypatch.setattr(band_cr, "cr_solve",
                        lambda D, U, rhs, refine: (rhs, torch.tensor(accepted), 0))
    params = dict(graphs.KITTI00_LOOP, num_poses=60, num_landmarks=1200)
    port = bench_pcg_band_mc.engine_of(params, "cpu", torch.float32)
    m = bench_pcg_band_mc.measure(port, 1, PCG_TOL, "cpu")
    out = capsys.readouterr().out
    assert m["band_ok"] is accepted and f"band solve accepted={accepted}" in out
    assert m["crossover"] == (1 if accepted else None)
    assert ("crossover: none reported" in out) is not accepted


@pytest.mark.parametrize("n", [512, 768])
def test_dense_solve_matches_cuba_tpu_fp64(n):
    """perf_probe_solve's system and solve at small n in fp64 against
    ``cuba_tpu``'s ``cholesky_solve`` (its XLA sweeps) on the same A, b."""
    A, b = perf_probe_solve.system(n, "cpu", F64)
    assert torch.allclose(A, A.T) and torch.allclose(A.diagonal(), torch.full((n,), 1.2, dtype=F64))
    for refine in (0, 1, 2):
        x, ok = perf_probe_solve.solve(A, b, refine)
        want, want_ok = tpu_dense.cholesky_solve(jnp.asarray(_np(A)), jnp.asarray(_np(b)),
                                                 refine, use_pallas=False)
        assert bool(ok) and bool(want_ok)
        np.testing.assert_allclose(_np(x), np.asarray(want), rtol=1e-10, atol=1e-13)
    err = perf_probe_solve.accuracy(A, b)
    assert all(e < 1e-12 for e in err.values())


def _unzip_md5(path) -> str:
    with gzip.open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


@pytest.mark.parametrize("args,committed,md5", [
    ([], "data/bal_toy.txt.gz", "d6313ec8435ee9b119310505cdd1ad3c"),
    (["--ladybug-scale"], "data/bal_ladybug_scale.txt.gz", "45e44514d702341a8938c08f170c117b"),
])
def test_bal_fixture_writer_reproduces_the_committed_fixtures(tmp_path, args, committed, md5):
    """The decompressed text of the writer's output is the committed
    fixture's byte for byte (the gzip header carries a time)."""
    out = tmp_path / "fixture.txt.gz"
    assert make_bal_fixture.main(args + [str(out)]) == 0
    assert _unzip_md5(out) == _unzip_md5(os.path.join(REPO, committed)) == md5


@pytest.mark.parametrize("seed,clustered", [(11, False), (29, True)])
def test_bal_fixture_writer_matches_the_jax_script(seed, clustered):
    """At other seeds the generator gives the JAX package's script's
    numbers, and the text is the script's."""
    spec = importlib.util.spec_from_file_location(
        "jax_make_bal_fixture", os.path.join(REPO, "tools", "make_bal_fixture.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    kw = dict(n_cams=12, n_pts=300, seed=seed, clustered=clustered)
    got, want = make_bal_fixture.generate(**kw), ref.generate(**kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
