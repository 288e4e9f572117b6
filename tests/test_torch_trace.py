"""The port's spans (``cuba_tpu_torch/trace.py``) on the CPU, under
``torch.profiler`` with CPU activity, on the tool tests' small band graph
(600 P / 12,000 L) through the public API: every span name appears once
``initialize()`` and ``optimize()`` have run; the LM phases nest under
``optimize``, the planner's spans under ``engine`` and the symbolic pass's
under ``structure``; one ``read.*`` span a host read that
``LMResult.host_reads`` counts, on ``band_cr``, ``dense_cholesky`` and
``pcg``; the dense solve's spans, one ``dense.cholesky`` a factorisation
(a boost retry opens another); the phase spans and ``PhaseMarks`` share
their boundaries; and an unprofiled ``optimize`` makes no
``record_function`` call.
"""

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from cuba_tpu_torch import BAConfig
from cuba_tpu_torch.io import synthetic
from cuba_tpu_torch.solver import dense_cholesky, engine
from cuba_tpu_torch.tools import graphs

BAND = dict(num_poses=600, num_landmarks=12000, mean_obs_per_landmark=5.0,
            stereo_fraction=0.25, seed=0)  # v2, band_cr with 10 CR blocks
SOLVERS = ("band_cr", "dense_cholesky", "pcg")
ITERS = 3
PHASES = ("lm.error", "lm.build", "lm.schur", "lm.decomp", "lm.update")
NAMES = {
    "structure", "structure.band_perm", "structure.locality", "structure.symbolic",
    "engine", "engine.resolve", "engine.plan_rows", "plan.row_tables", "plan.schur_lane_csr",
    "engine.upload", "optimize", *PHASES,
    "read.accept", "read.cr_boost", "read.dense_boost", "read.cg_stop", "read.chis",
    "rows.edge_residuals", "rows.edge_terms", "rows.prepare_factors", "rows.back_substitute",
    "rows.schur_matvec", "rows.block_diag_inv", "cr.factor", "cr.solve", "dense",
    "dense.cholesky", "dense.factor", "dense.solve", "k.gather_cols", "k.segsum_csr", "k.schur_fused", "k.compact_to_band",
    "k.compact_to_dense", "k.edge_terms", "k.hll_inverse", "k.slot_factors",
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def prob():
    return synthetic.generate(**BAND)


def _spans(prof):
    """[(name without "cuba.", start us, end us)] of a CPU profile."""
    return [(e.name[5:], e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CPU and e.name.startswith("cuba.")]


@pytest.fixture(scope="module")
def traced(prob):
    """{solver: (spans, LMResult, PhaseMarks)}: initialize() and
    optimize(ITERS) under the profiler, with the phase marks on."""
    out = {}
    for solver in SOLVERS:
        torch.set_num_threads(1)
        ba = graphs.make_graph(prob, BAConfig(device="cpu", solver=solver,
                                              phase_attribution=True))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            ba.initialize()
            ba.optimize(ITERS)
        marks = ba._pending_attr[-1][1]
        assert ba._engine.solver == solver
        out[solver] = (_spans(prof), ba.last_result, marks)
    return out


def _inside(spans, child, parent):
    """Every span called ``child`` lies inside a span called ``parent``."""
    outer = [(a, b) for n, a, b in spans if n == parent]
    kids = [(a, b) for n, a, b in spans if n == child]
    return bool(kids) and all(any(a0 <= a and b <= b0 for a0, b0 in outer) for a, b in kids)


def test_every_span_is_named(traced):
    seen = set()
    for spans, _res, _marks in traced.values():
        seen |= {n for n, _a, _b in spans}
    assert NAMES <= seen, NAMES - seen
    # nothing under the benchmark's own prefix, no name off the list
    # the blocked sweeps' spans: on the card's dense route (below: a direct call)
    assert seen <= NAMES | {"dense.prepare", "k.extract_diag", "k.solve_lower", "k.solve_upper",
                            "k.matvec"}


@pytest.mark.parametrize("solver", SOLVERS)
def test_spans_nest_under_their_layer(traced, solver):
    spans, res, _marks = traced[solver]
    for phase in PHASES:
        assert _inside(spans, phase, "optimize"), phase
    for child in ("engine.resolve", "engine.plan_rows", "plan.row_tables", "engine.upload"):
        assert _inside(spans, child, "engine"), child
    for child in ("structure.band_perm", "structure.locality", "structure.symbolic"):
        assert _inside(spans, child, "structure"), child
    # the phases follow one another: none overlaps another
    ph = sorted((a, b) for n, a, b in spans if n in PHASES)
    assert all(b0 <= a1 for (_a0, b0), (a1, _b1) in zip(ph, ph[1:]))
    # the accept and trajectory reads lie in no phase, the solvers' in the
    # decomposition's
    for n, a, b in spans:
        if n.startswith("read."):
            within = [p for p, a0, b0 in spans if p in PHASES and a0 <= a and b <= b0]
            assert within == ([] if n in ("read.accept", "read.chis") else ["lm.decomp"]), n
    assert sum(1 for n, _a, _b in spans if n == "lm.decomp") == res.nattempts


@pytest.mark.parametrize("solver", SOLVERS)
def test_read_spans_count_host_reads(traced, solver):
    spans, res, _marks = traced[solver]
    reads = [n for n, _a, _b in spans if n.startswith("read.")]
    assert len(reads) == res.host_reads > res.nattempts
    assert reads.count("read.accept") == res.nattempts and reads.count("read.chis") == 1


@pytest.mark.parametrize("solver", SOLVERS)
def test_phase_spans_and_marks_share_boundaries(traced, solver):
    """The phase spans, in time order, are the intervals PhaseMarks charges,
    one for one: one boundary call feeds both."""
    spans, _res, marks = traced[solver]
    names = dict(zip(engine.LOOP_PHASES, PHASES))
    charged = [names[phase] for phase, _t in marks.marks[1:] if phase is not None]
    assert charged == [n for n, _a, _b in sorted(spans, key=lambda x: x[1]) if n in PHASES]
    assert set(charged) == set(PHASES)


def test_dense_spans_nest_one_factor_an_attempt(traced):
    """One ``dense`` span a solve, inside the decomposition; its factor
    opens one ``dense.cholesky`` a factorisation, one for each boost
    decision read where every factor succeeds."""
    spans, res, _marks = traced["dense_cholesky"]
    names = [n for n, _a, _b in spans]
    assert names.count("dense") == res.nattempts
    assert _inside(spans, "dense", "lm.decomp")
    for child in ("dense.factor", "dense.solve"):
        assert _inside(spans, child, "dense"), child
    assert _inside(spans, "dense.cholesky", "dense.factor")
    assert names.count("dense.cholesky") == names.count("read.dense_boost") == res.nattempts


def _profiled_solve(A, b, refine):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _x, ok, reads = dense_cholesky.cholesky_solve(A, b, refine, use_kernels=True)
    assert bool(ok)
    spans = _spans(prof)
    return spans, [n for n, _a, _b in spans], reads


def test_dense_route_with_the_sweeps_opens_prepare():
    """With the blocked sweeps (the card's route; their plain versions
    here) the solve opens ``dense.prepare`` around the diagonal blocks'
    inverses, and the sweeps' and the refinement's kernel spans inside
    ``dense``."""
    n = 512
    g = torch.Generator().manual_seed(3)
    M = torch.randn(n, n, generator=g)
    A = M @ M.T / n + torch.eye(n)
    spans, names, reads = _profiled_solve(A, torch.randn(n, generator=g), 1)
    assert names.count("dense") == 1 and names.count("dense.prepare") == 1
    assert names.count("dense.cholesky") == 1 == reads
    assert _inside(spans, "k.extract_diag", "dense.prepare")
    for child in ("dense.factor", "dense.prepare", "dense.solve", "k.matvec"):
        assert _inside(spans, child, "dense"), child
    assert names.count("k.solve_lower") == names.count("k.solve_upper") == 2


def test_a_boost_retry_opens_a_second_factor():
    """A system whose first fp32 factor fails (a 2x2 block just past
    singular) and whose first boost (1e-5) factors: two ``dense.cholesky``
    spans in one solve, two boost reads."""
    n = 512
    A = torch.eye(n)
    A[0, 1] = A[1, 0] = 1.0 + 2.0 ** -20
    _spans_, names, reads = _profiled_solve(A, torch.ones(n), 0)
    assert names.count("dense.cholesky") == 2 == reads
    assert names.count("dense.factor") == 1 and names.count("dense") == 1


def test_unprofiled_optimize_calls_no_record_function(prob, monkeypatch):
    ba = graphs.make_graph(prob, BAConfig(device="cpu"))

    def refuse(*_a, **_k):
        raise AssertionError("record_function called with no profiler on")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    ba.initialize()
    ba.optimize(2)
    assert ba.last_result.niters == 2
