"""The port's tools (``cuba_tpu_torch/tools/``) on the CPU.

The large-landmark tool's graph at a reduced size against ``cuba_tpu``'s
fp64 engine (the XLA path, ``mxu="off"``) per iteration to 1e-6; each
tool's ``main([... "--device", "cpu"])`` at a tiny size; each tool's
refusal to run without the card it asks for by default; the crossover's
error rule; the split of ``initialize()`` by the spans inside it; the
kitti07 parity against the oracle copy at 12 poses / 300 landmarks; the
roofline work counts against hand counts; the roofline table's call sites
equal to ``chip_smoke.py``'s kernel checks; and the probes' yardstick,
this checkout's, over a tree without one.  The later tools' computations
against ``cuba_tpu`` are ``test_torch_tools_solve.py``'s and
``test_torch_tools_mc.py``'s; their ``main`` runs here.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import cuba_tpu
from cuba_tpu.io import synthetic as tpu_synthetic
from cuba_tpu.ops import robust as tpu_robust
from cuba_tpu.solver import engine as tpu_engine
from cuba_tpu.solver import structure as tpu_structure
from cuba_tpu_torch import BAConfig
from cuba_tpu_torch.io import synthetic
from cuba_tpu_torch.ops import segmm
from cuba_tpu_torch.solver import rows
from cuba_tpu_torch.tools import (bench_multichip_mxu, bench_pcg_band_mc, bench_pcg_crossover,
                                  graphs, make_bal_fixture, mc_parity, mfu, parity_kitti00,
                                  parity_kitti07, parity_records, perf_probe_solve,
                                  profile_crsolve, profile_ctor, profile_formation, roofline,
                                  stress_large_l)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--poses", "48", "--landmarks", "8000"]  # the stress generator, reduced
BAND = dict(num_poses=600, num_landmarks=12000, mean_obs_per_landmark=5.0,
            stereo_fraction=0.25, seed=0)  # v2, band_cr with 10 CR blocks


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _tpu_chis(solver, iters):
    """cuba_tpu's fp64 XLA engine on the stress generator's reduced graph."""
    prob = tpu_synthetic.generate(num_poses=48, num_landmarks=8000, mean_obs_per_landmark=5.0,
                                  stereo_fraction=0.25, seed=0)
    P, L = prob.qs.shape[0], prob.Xws.shape[0]
    fp = np.zeros(P, bool)
    fp[prob.fixed_poses] = True
    s = tpu_structure.build_structure_from_arrays(
        prob.qs, prob.ts, np.tile(prob.cam, (P, 1)), prob.Xws, fp, np.zeros(L, bool),
        prob.mono_p, prob.mono_l, prob.mono_z, prob.mono_w,
        prob.stereo_p, prob.stereo_l, prob.stereo_z, prob.stereo_w)
    kernels = ((tpu_robust.HUBER, float(np.sqrt(5.991))),
               (tpu_robust.HUBER, float(np.sqrt(7.815))))
    eng = tpu_engine.BlockSolverEngine(
        s, kernels, cuba_tpu.BAConfig(dtype=jnp.float64, solver=solver, mxu="off"))
    res = eng.optimize(None, iters)
    return eng.solver, np.asarray(res.chis)[: int(res.niters)]


@pytest.mark.parametrize("solver", ["band_cr", "auto"])
def test_stress_graph_matches_cuba_tpu_fp64(solver):
    """The stress tool's problem and engine at 48 P / 8,000 L, fp64 on the
    CPU: cuba_tpu's solver choice and, per iteration, its chi² to 1e-6."""
    args = stress_large_l.parse(SMALL + ["--solver", solver, "--dtype", "float64",
                                         "--device", "cpu"])
    eng = stress_large_l.engine_of(graphs.structure_of(stress_large_l.problem(args)), args)
    got = np.asarray(eng.optimize(eng.state, 6).chis)
    want_solver, want = _tpu_chis(solver, 6)
    assert eng.solver == want_solver and eng.path == "v2"
    assert len(got) == len(want) >= 5
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[-1] < got[0]


def test_stress_tool_main_on_cpu(capsys):
    assert stress_large_l.main(SMALL + ["--iters", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for line in ("generate:", "structure:", "ctor:", "route=v2", "kwin=128", "memory plan",
                 "schur_fused output [36, ", "W [18, ", "optimize(3): cold", "chi2:",
                 "STRESS OK"):
        assert line in out, line


def test_stress_memory_plan_reads_the_engine():
    """The memory plan's bytes are the engine's tensors' own: HplT and W
    [18, hpl_pad], the schur_fused output [36, C * kwin]."""
    args = stress_large_l.parse(SMALL + ["--device", "cpu"])
    eng = stress_large_l.engine_of(graphs.structure_of(stress_large_l.problem(args)), args)
    plan = dict(stress_large_l.memory_plan(eng))
    hpl = eng.plan.hpl_pad
    sc = eng.plan.schur
    assert plan[f"HplT [18, {hpl}] float32"] == plan[f"W [18, {hpl}] float32"] == 4 * 18 * hpl
    assert plan[f"schur_fused output [36, {sc.num_chunks * sc.kwin}] float32"] == \
        4 * 36 * sc.num_chunks * sc.kwin


TOOL_RUNS = {
    "stress_large_l": (stress_large_l, SMALL + ["--iters", "2"], "STRESS OK"),
    "bench_pcg_crossover": (bench_pcg_crossover,
                            ["--scales", "128", "--iters", "1", "--trials", "1"],
                            '"summary": "solver_crossover"'),
    "mfu": (mfu, ["--poses", "60", "--landmarks", "1500"], "| schur_fused |"),
    "profile_ctor": (profile_ctor, ["--poses", "60", "--landmarks", "1500", "--trials", "1"],
                     "symbolic pass"),
    "parity_kitti07": (parity_kitti07, ["--poses", "12", "--landmarks", "300"], "PASS"),
    "profile_formation": (profile_formation, ["--poses", "130", "--landmarks", "3000", "--reps",
                                              "1"], "marginals (call ms)"),
    "profile_crsolve": (profile_crsolve, [], "host reads of one cr_solve: 1"),
    "perf_probe_solve": (perf_probe_solve, ["--n", "512", "--reps", "1"],
                         "solve rel err refine=2"),
    "bench_pcg_band_mc": (bench_pcg_band_mc, ["--poses", "130", "--landmarks", "3000", "--reps",
                                              "1"], "crossover: sharded PCG"),
    "bench_multichip_mxu": (bench_multichip_mxu, ["--poses", "12", "--landmarks", "300",
                                                  "--trials", "1", "--iters", "3"],
                            "equals the single-device one bit for bit"),
    "mc_parity": (mc_parity, ["--poses", "12", "--landmarks", "300"], "-> OK"),
    "parity_kitti00": (parity_kitti00, ["--phase", "fp64", "--poses", "12", "--landmarks", "300",
                                        "--shapes", "kitti07_scale"], "CHI2_FP64_FINAL"),
    "parity_records": (parity_records, ["--phase", "fp64", "--entries", "ladybug49_bal"],
                       "# ladybug49_bal: fp64 10 iters on cpu"),
    "make_bal_fixture": (make_bal_fixture, ["{tmp}/toy.txt.gz"], "20 cams / 500 pts / 4989 obs"),
}
NO_DEVICE = ("make_bal_fixture",)  # NumPy and SciPy only


def _tool_argv(tool, tmp_path, monkeypatch):
    """(module, argv, expected line) of a TOOL_RUNS case, every file it
    writes under ``tmp_path``."""
    module, argv, line = TOOL_RUNS[tool]
    argv = [a.replace("{tmp}", str(tmp_path)) for a in argv]
    if tool == "parity_kitti07":
        argv += ["--out", str(tmp_path / "p.md")]
    if tool == "parity_kitti00":
        monkeypatch.setattr(parity_kitti00, "RECORD", str(tmp_path / "record.json"))
        monkeypatch.setattr(parity_kitti00, "OUT", str(tmp_path / "p.md"))
    if tool == "parity_records":
        monkeypatch.setattr(parity_records, "RECORD", str(tmp_path / "record.json"))
    return module, argv, line


@pytest.mark.parametrize("tool", sorted(TOOL_RUNS))
def test_tool_main_runs_on_cpu(tool, tmp_path, capsys, monkeypatch):
    module, argv, line = _tool_argv(tool, tmp_path, monkeypatch)
    device = [] if tool in NO_DEVICE else ["--device", "cpu"]
    assert module.main(argv + device) == 0
    out = capsys.readouterr().out
    assert line in out


@pytest.mark.parametrize("tool", sorted(set(TOOL_RUNS) - set(NO_DEVICE)))
def test_tool_runs_on_the_card_by_default(tool, tmp_path, monkeypatch):
    """Without ``--device`` each tool asks for the card, and without one it
    fails before any work: none carries on on the host."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    module, argv, _line = _tool_argv(tool, tmp_path, monkeypatch)
    with pytest.raises(RuntimeError, match="--device cpu"):
        module.main(argv)
    assert not any(tmp_path.iterdir())


def test_crossover_reraises_errors_other_than_out_of_memory(monkeypatch, capsys):
    def fail(*_a, **_k):
        raise ValueError("not a memory fault")

    monkeypatch.setattr(bench_pcg_crossover, "run_one", fail)
    with pytest.raises(ValueError, match="memory fault"):
        bench_pcg_crossover.main(["--scales", "128", "--device", "cpu"])


def test_crossover_records_out_of_memory_and_goes_on(monkeypatch, capsys):
    real = bench_pcg_crossover.run_one

    def dense_oom(num_p, num_l, mean_obs, solver, *a):
        if solver == "dense_cholesky":
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 38 GiB")
        return real(num_p, num_l, mean_obs, solver, *a)

    monkeypatch.setattr(bench_pcg_crossover, "run_one", dense_oom)
    assert bench_pcg_crossover.main(["--scales", "128", "--iters", "1", "--trials", "1",
                                     "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    rows_ = [json.loads(x) for x in lines if x.startswith("{")]
    dense = next(r for r in rows_ if r.get("solver") == "dense_cholesky")
    assert dense["error"].startswith("OutOfMemoryError") and "wall_s" not in dense
    assert all("wall_s" in r for r in rows_ if r.get("solver") in ("band_cr", "pcg"))
    assert rows_[-1] == {"summary": "solver_crossover",
                         "first_P_where_scalable_beats_dense": 128}


def test_profile_ctor_steps_sum_to_initialize():
    """Every step span of one trial lies inside initialize()'s spans
    (``structure`` and ``engine``), the ones the split names are there, each
    step's own seconds are at most its seconds, and the unattributed and
    outside seconds are the rest of the wall."""
    r = profile_ctor.trial(synthetic.generate(**BAND), BAConfig(device="cpu"))
    roots = [(a, b) for n, a, b in r["spans"] if n in profile_ctor.ROOTS]
    assert sorted(n for n, _a, _b in r["spans"] if n in profile_ctor.ROOTS) == \
        ["engine", "structure"]
    for n, a, b in r["spans"]:
        assert any(a0 <= a and b <= b0 for a0, b0 in roots), n
    assert set(profile_ctor.WHAT) <= set(r["steps"])
    assert all(0 <= own <= sec + 1e-9 for sec, own in r["steps"].values())
    assert 0 <= r["unattributed"] and 0 <= r["outside"]
    assert r["unattributed"] + sum(own for _s, own in r["steps"].values()) + r["outside"] == \
        pytest.approx(r["wall"], rel=1e-6)
    assert r["first_residual"] > 0 and not torch.autograd.profiler._is_profiler_enabled
    assert (r["route"], r["solver"]) == ("v2", "band_cr")


def test_parity_kitti07_small_graph_against_the_oracle(tmp_path):
    """The parity tool at 12 P / 300 L: fp64 within 1e-6 a step of the
    oracle copy, estimates within the RMSE gates; fp32 within 5e-3; both
    sections kept in the file."""
    out = tmp_path / "parity.md"
    params = dict(graphs.KITTI07, num_poses=12, num_landmarks=300)
    eng, ref, cmp = parity_kitti07.run(params, "cpu", "float64", 10)
    assert cmp["ok"] and cmp["n"] == 10 and np.all(cmp["rel"] < 1e-6)
    assert cmp["q"] < 1e-8 and cmp["t"] < 1e-7 and cmp["Xw"] < 1e-7
    for dtype in ("float64", "float32"):
        assert parity_kitti07.main(["--poses", "12", "--landmarks", "300", "--device", "cpu",
                                    "--dtype", dtype, "--out", str(out)]) == 0
    text = out.read_text()
    assert text.startswith(parity_kitti07.TITLE)
    assert "## cpu float32" in text and "## cpu float64" in text and text.count("PASS") == 2


def test_roofline_work_counts():
    src = torch.zeros((2, 10))
    ids = torch.tensor([0, 3, 3, -1, 12], dtype=torch.int32)
    # 5 ids, 5 output columns of 2 rows, 2 distinct source columns
    assert roofline.gather_work(src, ids) == (4 * 5 + 4 * (2 * 5 + 2 * 2), 0)
    vals = torch.zeros((2, 5), dtype=torch.float64)
    ids = torch.tensor([0, 1, 1, -1, 7], dtype=torch.int32)
    # 3 values in range of 3 outputs, 2 rows: 6 adds
    assert roofline.segsum_work(vals, ids, 3) == (4 * 5 + 8 * (2 * 3 + 2 * 3), 6)
    assert roofline.bound(3.35e9, 0) == (1.0, "bytes")
    assert roofline.bound(0, 67e9) == (1.0, "operations")
    assert roofline.bound(0, 34e9, fp64=True) == (1.0, "operations")


def test_roofline_formation_work_counts():
    """schur_work, band_work and dense_work on small hand-made plans,
    against counts made by hand (the smoke's bounds of kernels 7-9)."""
    # schur_fused: 2 chunks of 2 triplets, windows of 4 slots, 3 lanes a chunk
    plan = SimpleNamespace(slot_block=4, chunk=2, num_chunks=2, kwin=3)
    sb = torch.tensor([0, 1], dtype=torch.int32)  # window bases 0 and 4
    li = torch.tensor([0, 1, -1, 2], dtype=torch.int32)
    lj = torch.tensor([1, 1, 0, 3], dtype=torch.int32)
    sc = (plan, sb, li, lj, None)
    csr = SimpleNamespace(order=torch.zeros(7, dtype=torch.int32),
                          offs=torch.zeros(7, dtype=torch.int32))
    # triplets 0, 1, 3 valid: W columns {0, 1, 6}, G columns {1, 7}: 5 of 18
    # values; 6 output lanes of 36; index ints 7 + 7 + 6 lanes + 2 sb
    assert roofline.schur_work(plan, sc, csr) == (4 * (18 * 5 + 36 * 6) + 4 * 22, 216 * 3)
    assert roofline.schur_work(plan, sc, csr, 8) == (8 * (18 * 5 + 36 * 6) + 4 * 22, 216 * 3)
    # compact_to_band: PB 128 (M = 2 band blocks of [384, 768]), 3 of 5 slots filled
    iru = torch.tensor([0, -1, 2, 4, -1], dtype=torch.int32)
    rc = SimpleNamespace(iru=iru, occ2=torch.zeros(4, dtype=torch.int32))
    band = 4 * (36 * 3 + 36 * 128 + 2 * 384 * 768) + 4 * (2 * 5 + 2 * 2)
    assert roofline.band_work(SimpleNamespace(pad_blocks=128), rc) == (band, 36 * 128)
    # compact_to_dense: PB 2 ([12, 12] output), the same slots, 4 occupancy ints
    dense = 8 * (36 * 3 + 36 * 2 + 36 * 2 * 2) + 4 * (2 * 5 + 4)
    assert roofline.dense_work(SimpleNamespace(pad_blocks=2), rc, 8) == (dense, 36 * 2)


def test_mfu_sites_are_the_smokes(monkeypatch):
    """The roofline table's sites (``roofline.engine_sites``) are the
    smoke's kernel checks, each calling its kernel on the smoke case's
    arguments: the gather and the segment sum on the initial state, schur_fused and the
    combine on the first attempt, and compact_to_band on its compact
    table."""
    monkeypatch.setattr(segmm, "kernel_attributes", lambda *a, **k: {})
    ba = graphs.make_graph(synthetic.generate(**BAND), BAConfig(device="cpu"))
    ba.initialize()
    eng = ba._engine
    sites = roofline.engine_sites(eng)
    cases = chip_smoke.kernel_cases(eng, torch, segmm)
    HppT, HplT, lam, W, _bsc = roofline.first_attempt(eng)
    cases.update(chip_smoke.schur_cases(eng, torch, segmm, HplT, W)[0])
    gT = rows.schur_compact(W, HplT, eng.plan, eng.rc)
    dbT = rows.damped_diagonal_T(HppT, lam, eng.num_p, eng.plan.pad_blocks)
    cases["compact_to_band"] = chip_smoke.band_case(gT, dbT, eng, segmm, torch)
    assert set(sites) == set(cases)
    for label, site in sites.items():
        assert torch.equal(site.call(site.wrapper()), cases[label][1](site.wrapper())), label


@pytest.mark.parametrize("solver, params", [
    ("band_cr", BAND), ("dense_cholesky", dict(num_poses=40, num_landmarks=600, seed=0))])
def test_placement_library_call_is_the_plain_placement(solver, params):
    """``roofline.placement_library``, the placements' library call the
    smoke times (one accumulating ``index_put_`` over a flat index built
    once per structure), gives the plain placement's bits on the first
    attempt's compact table and damped diagonal; the smoke's placement
    case carries it."""
    ba = graphs.make_graph(synthetic.generate(**params), BAConfig(device="cpu", solver=solver))
    ba.initialize()
    eng = ba._engine
    HppT, HplT, lam, W, _bsc = roofline.first_attempt(eng)
    gT = rows.schur_compact(W, HplT, eng.plan, eng.rc)
    dbT = rows.damped_diagonal_T(HppT, lam, eng.num_p, eng.plan.pad_blocks)
    site = roofline.placement_site(eng, gT, dbT, dense=solver == "dense_cholesky")
    want = site.call(site.plain())
    assert torch.equal(roofline.placement_library(site)(), want)
    assert int((want != 0).sum()) > 0


def test_first_attempt_at_a_fixed_lambda():
    """``roofline.first_attempt(engine, lam)`` damps the attempt at ``lam``
    (the solve tools' LAM0 = 1e-3), without it at the engine's τ·max diag."""
    ba = graphs.make_graph(synthetic.generate(**BAND), BAConfig(device="cpu"))
    ba.initialize()
    own = roofline.first_attempt(ba._engine)
    fixed = roofline.first_attempt(ba._engine, roofline.LAM0)
    assert roofline.LAM0 == 1e-3 and float(fixed[2]) == float(np.float32(1e-3))
    assert float(own[2]) > 1.0
    assert torch.equal(own[0], fixed[0]) and torch.equal(own[1], fixed[1])
    assert not torch.equal(own[3], fixed[3])


def test_probe_loader_keeps_this_checkouts_yardstick(tmp_path):
    """The probes' ``--root DIR`` over a tree from before ``roofline.py``
    and ``graphs.py`` existed: the package comes from DIR, the yardstick
    and the graphs that ``chip_smoke.py`` uses from this checkout."""
    import shutil

    old = tmp_path / "old"
    shutil.copytree(os.path.join(REPO, "cuba_tpu_torch"), old / "cuba_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    tools = old / "cuba_tpu_torch" / "tools"
    for f in tools.iterdir():
        if not f.name.startswith("probe_"):
            f.unlink()
    here = os.path.join(REPO, "cuba_tpu_torch", "tools")
    code = ("import sys\n"
            f"sys.path.insert(0, {here!r})\n"
            "import smoke_loader\n"
            f"smoke = smoke_loader.load_smoke({str(old)!r})\n"
            "import cuba_tpu_torch\n"
            "from cuba_tpu_torch.ops import segmm\n"
            f"assert cuba_tpu_torch.__file__.startswith({str(old)!r}), cuba_tpu_torch.__file__\n"
            f"assert segmm.__file__.startswith({str(old)!r}), segmm.__file__\n"
            f"assert smoke.roofline.__file__ == {os.path.join(here, 'roofline.py')!r}\n"
            f"assert smoke.graphs.__file__ == {os.path.join(here, 'graphs.py')!r}\n"
            "assert smoke.KITTI == smoke.graphs.KITTI00_LOOP\n"
            f"assert smoke.parity_records.__file__ == {os.path.join(here, 'parity_records.py')!r}\n"
            "assert smoke.roofline.bound(3.35e9, 0) == (1.0, 'bytes')\n"
            "assert callable(smoke.interleaved_times)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr


def test_tools_import_no_jax():
    """The tools in a fresh interpreter: no JAX, nothing of cuba_tpu."""
    code = ("import sys\n"
            "from cuba_tpu_torch.tools import (bench_multichip_mxu, bench_pcg_band_mc,"
            " bench_pcg_crossover, graphs, make_bal_fixture, mc_parity, mfu, parity_kitti00,"
            " parity_kitti07, parity_records, perf_probe_solve, profile_crsolve, profile_ctor,"
            " profile_formation,"
            " roofline, stress_large_l)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'cuba_tpu.'))"
            " or m == 'cuba_tpu']\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, r.stderr
