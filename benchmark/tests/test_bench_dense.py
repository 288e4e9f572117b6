"""CPU tests of the dense route's cell, ``kitti07.solve``: the plain
reference agrees with the port where ``auto`` resolves ``dense_cholesky``
and its control fails the cell's limits, on a small graph of the
configuration's own generator; the work counts of ``dense_work.py``
against a brute-force count over the plain sweeps' loops and against
``tools/roofline.dense_work``; and the four dense readers' arithmetic on
hand-built spans.

    python -m pytest benchmark/tests -q
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from benchmark import compare, dense_work, generator, program, run, spans
from benchmark.spans import Launch, ProgramSpans, Span

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELL = "kitti07.solve"
CFG = run.load_config(BENCH, "kitti07")
# the configuration's ~105 landmarks a pose at 60 poses (n = 768).  At 20 a
# pose (150 P / 3,000 L) the graph is so weakly held that fp32 answers of
# every solver, the plain fp32 reference's too, put camera centres 0.03-0.4 m
# from the fp64 reference's, past the cell's pose limit
SMALL = dict(CFG["generator"], num_poses=60, num_landmarks=6300)


def _engine(prob, dtype):
    s = program.structure(prob)
    return s, program.engine(s, CFG["huber_deltas"], program.make_config(CFG, dtype, "cpu"))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_reference_agrees_with_the_port_on_the_dense_route(dtype):
    prob = generator.generate(seed=11, **SMALL)
    s, eng = _engine(prob, dtype)
    assert (eng.solver, eng.path) == ("dense_cholesky", "v2")
    res, host = program.solve(eng, CFG["iterations"])
    judge = compare.Judge(prob, CFG, "cpu")
    nums = judge.answer_numbers(res.chis, *program.caller_order(s, host, prob.fixed_poses))
    limits = compare.load_limits(CELL if dtype == "float32" else "kitti00-loop.solve-fp64")
    assert compare.verdict(nums, limits), nums
    if dtype == "float64":
        assert nums["chi2_gap"] < 1e-12 and nums["pose_gap_m"] < 1e-9


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_the_control_fails_the_dense_cell(seed):
    """The reference in fp32 with TF32 products, in the program's place,
    is not correct under ``kitti07.solve``'s limits."""
    prob = generator.generate(seed=seed, **SMALL)
    judge = compare.Judge(prob, CFG, "cpu")
    ctl = compare.reference_of(prob, CFG, "cpu", dtype=torch.float32, tf32=True)
    chis, (R, t, X) = ctl.optimize(CFG["iterations"])
    nums = judge.numbers(chis, R.double(), t.double(), X.double())
    assert not compare.verdict(nums, compare.load_limits(CELL)), nums


# -- the work counts ------------------------------------------------------------

def _sweep_brute_force(n, block, upper):
    """(values read, multiply-adds) of ``trisolve.solve_lower_plain`` /
    ``solve_upper_plain``'s loops, each value of L and invd counted once."""
    K = n // block
    L_read = np.zeros((n, n), bool)
    inv_read = np.zeros((K, block, block), bool)
    madds = 0
    for k in (reversed(range(K)) if upper else range(K)):
        lo, hi = k * block, (k + 1) * block
        inv_read[k] = True
        madds += block * block
        if upper:
            L_read[lo:hi, :lo] = True
            madds += block * lo
        else:
            L_read[hi:, lo:hi] = True
            madds += (n - hi) * block
    return int(L_read.sum() + inv_read.sum()) + 2 * n, madds


@pytest.mark.parametrize("n,block", [(512, 256), (1536, 256), (768, 128)])
def test_sweep_work_against_the_plain_sweeps(n, block):
    for upper in (False, True):
        values, madds = _sweep_brute_force(n, block, upper)
        assert dense_work.sweep_work(n, block) == (4 * values, 2 * madds)


@pytest.mark.parametrize("n", [512, 1536])
def test_extract_matvec_and_factor_work(n):
    K = n // dense_work.BLOCK
    diag = np.zeros((n, n), bool)
    for k in range(K):
        diag[k * 256:(k + 1) * 256, k * 256:(k + 1) * 256] = True
    assert dense_work.extract_diag_work(n) == (2 * 4 * int(diag.sum()), 0)
    assert dense_work.matvec_work(n) == (4 * (n * n + n + n), 2 * n * n)
    nbytes, flops = dense_work.factor_work(n)
    assert nbytes == 8 * n * n and flops == pytest.approx(n ** 3 / 3)


def test_factor_least_time_at_kitti07():
    """n = 1536: 1.21 G operations bound it at ~18 us (67 TFLOP/s), not its
    18.9 MB (5.6 us at 3.35 TB/s)."""
    least = dense_work.least_seconds(dense_work.factor_work(1536))
    assert least == pytest.approx(1536 ** 3 / 3 / 67e12)
    assert 17e-6 < least < 19e-6


def test_placement_work_is_the_roofline_tools_count():
    from cuba_tpu_torch.tools import roofline

    _s, eng = _engine(generator.generate(seed=5, **SMALL), "float32")
    assert eng.solver == "dense_cholesky"
    work = dense_work.engine_kernel_work(eng)
    assert work["k.compact_to_dense"] == roofline.dense_work(eng.plan, eng.rc)
    n = 6 * eng.plan.pad_blocks
    assert work["k.solve_lower"] == work["k.solve_upper"] == dense_work.sweep_work(n)
    assert set(work) == {"k.compact_to_dense", "k.extract_diag", "k.solve_lower",
                         "k.solve_upper", "k.matvec"}


# -- the readers on hand-built spans ------------------------------------------------

PB = 256
N = 6 * PB


def _fake_engine():
    iru = torch.full((3072,), -1, dtype=torch.int32)
    iru[:2662] = 0
    return types.SimpleNamespace(plan=types.SimpleNamespace(pad_blocks=PB),
                                 rc=types.SimpleNamespace(iru=iru, occ2=torch.ones(8)))


def _attempt(base, retry):
    """One attempt's dense spans and launches from ``base`` us: a placement
    in the Schur phase, then the solve; with ``retry`` a second factor."""
    s = [Span("lm.schur", base, base + 10), Span("k.compact_to_dense", base + 1, base + 3),
         Span("lm.decomp", base + 10, base + 60), Span("dense", base + 11, base + 59),
         Span("dense.factor", base + 12, base + 30), Span("dense.cholesky", base + 13, base + 16),
         Span("read.dense_boost", base + 17, base + 18),
         Span("dense.prepare", base + 31, base + 36), Span("k.extract_diag", base + 32, base + 33),
         Span("dense.solve", base + 40, base + 50), Span("k.solve_lower", base + 41, base + 42),
         Span("k.solve_upper", base + 43, base + 44), Span("k.matvec", base + 52, base + 53)]
    ln = [Launch(base + 2, 4.0, "compact_to_dense"), Launch(base + 11.5, 2.0, "equilibrate"),
          Launch(base + 14, 500.0, "potrf"), Launch(base + 32.5, 3.0, "extract_diag"),
          Launch(base + 34, 20.0, "trsm"), Launch(base + 41.5, 15.0, "solve_lower"),
          Launch(base + 43.5, 20.0, "solve_upper"), Launch(base + 52.5, 5.0, "matvec"),
          Launch(base + 58, 1.0, "where")]
    if retry:
        s.append(Span("dense.cholesky", base + 20, base + 25))
        ln.append(Launch(base + 21, 500.0, "potrf"))
    return s, ln


def _ps(retries=(False, True)):
    s, launches = [Span("optimize", 0, 1000)], []
    for i, retry in enumerate(retries):
        a, b = _attempt(100 * i, retry)
        s += a
        launches += b
    spans.attach(s, launches)
    return ProgramSpans(s, spans.by_innermost(s, launches), {}, len(retries), 1e-3)


def _fake(ps, engine=True):
    return types.SimpleNamespace(device="cuda", _program_spans=ps,
                                 engine=_fake_engine() if engine else None)


def test_dense_readers():
    ps = _ps()
    device = run.load_reader("dense_device_ms_per_attempt")
    factors = run.load_reader("factors_per_attempt")
    factor_roof = run.load_reader("dense_factor_roofline")
    kernels_roof = run.load_reader("dense_kernels_roofline")
    # inside dense: 2 + 500 + 3 + 20 + 15 + 20 + 5 + 1 = 566 us an attempt, + 500 on the retry
    assert device(_fake(ps)) == pytest.approx((566 + 1066) / 2 / 1e3)
    assert factors(_fake(ps)) == pytest.approx(1.5)
    assert factors(_fake(_ps((False, False)))) == pytest.approx(1.0)
    least = dense_work.least_seconds(dense_work.factor_work(N))
    assert factor_roof(_fake(ps)) == pytest.approx(100 * least / (1500e-6 / 2))
    work = dense_work.kernel_work(N, PB, 2662, 3072, 8)
    calls = 2 * sum(dense_work.least_seconds(c) for c in work.values())
    assert kernels_roof(_fake(ps)) == pytest.approx(100 * calls / (2 * 47e-6))
    assert dense_work.engine_kernel_work(_fake_engine()) == work


def test_dense_readers_read_nothing_without_their_spans():
    readers = [run.load_reader(n) for n in ("dense_device_ms_per_attempt", "factors_per_attempt",
                                             "dense_factor_roofline", "dense_kernels_roofline")]
    # a program without the dense spans (the band route, or a program from
    # before them) and a request with no kernel of the dense route
    band = ProgramSpans([Span("optimize", 0, 10), Span("cr.factor", 1, 5)], {}, {}, 2, 1.0)
    for reader in readers:
        assert reader(_fake(None)) is None
        assert reader(_fake(band)) is None
        assert reader(_fake(_ps(()))) is None  # no attempt
    for reader in readers[2:]:
        assert reader(_fake(_ps(), engine=False)) is None
    # the hand kernels' spans are older than the dense spans: the kernels'
    # share reads wherever they ran
    old = [s for s in _ps().spans if not s.name.startswith("dense")]
    assert readers[3](_fake(ProgramSpans(old, {}, {}, 2, 1.0))) == pytest.approx(
        readers[3](_fake(_ps())))
