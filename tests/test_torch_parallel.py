"""The landmark-sharded LM of cuba_tpu_torch (``parallel/``) against
cuba_tpu's ``parallel/`` on the CPU.

The port's ranks run over gloo, spawned through ``parallel.launch.spawn``
(each rank imports only the port, one thread each); cuba_tpu's
``MultiChipEngine`` runs in this process on the 4- and 8-device virtual
CPU mesh of ``tests/conftest.py``.  The cases of one world size run in one
spawned group, started in the background by a module fixture while the
tests compute cuba_tpu's side.

Bars (``tests/test_multichip.py``, ``test_multichip_mxu.py``): fp64, chi²
within 1e-6 relative per iteration and landmarks within 1e-6, the same
solver resolved; fp32 against the interpret-mode mesh, 5e-3.  At S = 1 the
sharded engine equals the single-device one bit for bit, and every rank's
trajectory and state are the same bits.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import cuba_tpu
import cuba_tpu_torch
from cuba_tpu.io import synthetic as tpu_synthetic
from cuba_tpu.parallel import mxu_shard
from cuba_tpu.parallel import sharding as tpu_sharding
from cuba_tpu.solver import engine as tpu_engine
from cuba_tpu.solver import structure as tpu_structure
from cuba_tpu_torch import interop
from cuba_tpu_torch.interop import structure_from_numpy
from cuba_tpu_torch.io import synthetic
from cuba_tpu_torch.parallel import drive, launch, rows_shard, sharding
from cuba_tpu_torch.solver import comm, engine, rows

torch.set_num_threads(1)

HUBER = float(np.sqrt(5.991))
F64 = torch.float64


def _scattered(num_p=150, num_l=1200, seed=0):
    """Scattered covisibility (each landmark seen from four random poses,
    tests/test_torch_aos.py's kind): the single-device planner finds no
    plan, and every shard's plan lacks the v2 tables."""
    rng = np.random.default_rng(seed)
    mp = np.concatenate([rng.choice(num_p, size=4, replace=False) for _ in range(num_l)])
    e = np.zeros((0,), np.int32)
    fp = np.zeros(num_p, bool)
    fp[0] = True
    return tpu_structure.build_structure_from_arrays(
        np.tile(np.array([0.0, 0, 0, 1]), (num_p, 1)), rng.normal(size=(num_p, 3)) * 0.1,
        np.tile(np.array([500.0, 500, 320, 240, 0.1]), (num_p, 1)),
        rng.normal(size=(num_l, 3)) + np.array([0, 0, 5.0]), fp, np.zeros(num_l, bool),
        mp.astype(np.int32), np.repeat(np.arange(num_l, dtype=np.int32), 4),
        rng.normal(size=(mp.size, 2)) * 10 + np.array([320.0, 240]), np.ones(mp.size),
        e, e, np.zeros((0, 3)), np.zeros(0))


def _tpu_graph(P, L, seed, fix_every=0, robust=True, dtype=None, fix_from=None):
    ba = tpu_synthetic.build_graph(tpu_synthetic.generate(num_poses=P, num_landmarks=L,
                                                          seed=seed),
                                   config=cuba_tpu.BAConfig(dtype=dtype))
    if fix_every:
        for j in range(0, L, fix_every):
            ba.landmark_vertex(j).fixed = True
    if fix_from is not None:
        for j in range(fix_from, L):
            ba.landmark_vertex(j).fixed = True
    if robust:
        ba.set_robust_kernels(cuba_tpu.RobustKernelType.HUBER, HUBER,
                              cuba_tpu.EdgeType.MONOCULAR)
    ba.initialize()
    return ba._engine.structure, tuple((int(k[0]), float(k[1])) for k in ba._kernels)


_CACHE = {}


def _graph(name):
    """(cuba_tpu structure, kernels) of the tests' graphs."""
    if name not in _CACHE:
        if name == "g8":  # test_multichip.py:16-43
            _CACHE[name] = _tpu_graph(8, 64, 13)
        elif name == "g140":  # test_multichip.py:133-165
            _CACHE[name] = _tpu_graph(140, 900, 13)
        elif name == "g12":  # test_multichip.py:167
            _CACHE[name] = _tpu_graph(12, 120, 19)
        elif name == "g6f":  # test_multichip.py:109, fixed landmarks
            _CACHE[name] = _tpu_graph(6, 48, 17, fix_every=5, robust=False)
        elif name == "g6e":  # the same graph with landmarks 9.. fixed: at S = 4 the
            # last shard owns no active landmark (cuba_tpu's shard cut refuses)
            _CACHE[name] = _tpu_graph(6, 48, 17, fix_from=9, robust=False)
        elif name == "loop":  # test_multichip_mxu.py:120-160
            from test_band_lr import KERNELS, _loop_graph

            _CACHE[name] = (_loop_graph(num_p=160, num_l=1000, chords=4, seed=3),
                            tuple((int(k[0]), float(k[1])) for k in KERNELS))
        elif name == "scattered":
            _CACHE[name] = (_scattered(), ((1, HUBER), (0, 0.0)))
    return _CACHE[name]


def _case(name, graph, solver, dtype=F64, **kw):
    s, kernels = _graph(graph)
    return dict(name=name, kind="engine", structure=structure_from_numpy(s), kernels=kernels,
                iters=kw.pop("iters", 5), config=dict(dtype=dtype, solver=solver), **kw)


# (case, graph, solver, dtype, options) of the 4-rank group
FP64_CASES = {
    "g8_dense": ("g8", "dense_cholesky"),
    "g8_pcg": ("g8", "pcg"),
    "g140_band": ("g140", "band_cr"),
    "g140_auto": ("g140", "auto"),
    "g6f_auto": ("g6f", "auto"),
    "g6e_auto": ("g6e", "auto"),
    "scattered_auto": ("scattered", "auto"),
}
# the graphs whose shards do not take the rows route at S = 4
AOS_GRAPHS = ("g6e", "scattered")
S1_CASES = {
    "s1_g8_dense": ("g8", "dense_cholesky", F64, {}),
    "s1_g8_pcg": ("g8", "pcg", F64, {}),
    "s1_g140_band": ("g140", "band_cr", F64, {}),
    "s1_loop_band_lr": ("loop", "band_lr", F64, {}),
    "s1_g8_fp32": ("g8", "dense_cholesky", torch.float32, {}),
    "s1_scattered_auto": ("scattered", "auto", F64, {}),
    "s1_g8_aos_pcg": ("g8", "pcg", F64, {"aos": True}),
}


class _Ranks:
    """One spawned group, run in a background thread."""

    def __init__(self, n, cases, timeout=400.0):
        self._out = self._err = None
        self._thread = threading.Thread(target=self._run, args=(n, cases, timeout), daemon=True)
        self._thread.start()

    def _run(self, n, cases, timeout):
        try:
            self._out = launch.spawn(drive.run_cases, n, device="cpu", args=(cases,),
                                     timeout=timeout)
        except BaseException as e:  # re-raised by result()
            self._err = e

    def result(self):
        self._thread.join()
        if self._err is not None:
            raise self._err
        return self._out


@pytest.fixture(scope="module")
def ranks4():
    cases = [_case(n, g, s) for n, (g, s) in FP64_CASES.items()]
    cases += [_case("loop_band_lr", "loop", "band_lr"),
              _case("loop_band_lr_aos", "loop", "band_lr", aos=True),
              _case("g8_aos_pcg", "g8", "pcg", aos=True),
              _case("g8_fp32", "g8", "dense_cholesky", torch.float32, iters=4)]
    # the single-device engine of an AoS case runs in this process
    # (_single_aos): the ranks' engine cannot be told to skip its planner
    cases += [_case(n, g, s, dt, world=1, single=not kw.get("aos"), **kw)
              for n, (g, s, dt, kw) in S1_CASES.items()]
    prob = synthetic.generate(num_poses=8, num_landmarks=64, seed=13)
    cases.append(dict(name="api", kind="api", problem=prob, iters=5, profile_iters=3,
                      checkpoint=True, config=dict(dtype=F64)))
    return _Ranks(4, cases)


@pytest.fixture(scope="module")
def ranks8():
    return _Ranks(8, [_case("g12_pcg", "g12", "pcg")])


_SINGLE = {}


def _single_aos(graph, solver):
    """The single-device engine's AoS path (the planner closed) on a
    graph, fp64, run in this process with one thread as a rank runs: the
    results ``drive`` reports for ``single=True``."""
    if (graph, solver) not in _SINGLE:
        s, kernels = _graph(graph)
        torch.set_num_threads(1)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(rows, "plan_row_tables", lambda s, pad_blocks=0, lr=None: (None, None))
            eng = engine.BlockSolverEngine(
                structure_from_numpy(s), kernels,
                cuba_tpu_torch.BAConfig(dtype=F64, solver=solver, device="cpu"))
        assert eng.path == "aos"
        _SINGLE[graph, solver] = drive._result(eng.optimize(None, 5), eng.device)
    return _SINGLE[graph, solver]


def _same_on_every_rank(res, name, keys=("chis", "Xws", "qs", "ts")):
    for k in keys:
        for r in res[1:]:
            assert np.array_equal(r[f"{name}.{k}"], res[0][f"{name}.{k}"]), (name, k)


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), (tpu_sharding.AXIS,))


@functools.lru_cache(maxsize=None)
def _tpu_mesh_run(graph, solver, ndev=4, iters=5, **cfg):
    s, kernels = _graph(graph)
    eng = tpu_sharding.MultiChipEngine(s, kernels, cuba_tpu.BAConfig(solver=solver, **cfg),
                                       _mesh(ndev))
    chis, *_ = eng.optimize(iters)
    return eng, np.asarray(chis), eng.gathered_landmarks()


# ---------------------------------------------------------------------------
# host tables: the shard cut against cuba_tpu's rows cut and padded tables
# ---------------------------------------------------------------------------


def _fields_equal(a, b, what):
    for f in ("num_p", "num_l", "total_p", "total_l", "qs", "ts", "cams", "Xws", "hpl_row",
              "hpl_col", "edge2hpl", "hsc_row", "hsc_col", "mul_i", "mul_j", "mul_k"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype.kind == y.dtype.kind and np.array_equal(x, y), (what, f)
    for e in ("mono", "stereo"):
        for f in ("measurements", "omegas", "pose_idx", "lm_idx"):
            x = np.asarray(getattr(getattr(a, e), f))
            y = np.asarray(getattr(getattr(b, e), f))
            assert x.dtype.kind == y.dtype.kind and np.array_equal(x, y), (what, e, f)


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("graph", ["g8", "g6f", "loop"])
def test_shard_structures_match_cuba_tpu(graph, S):
    s, _ = _graph(graph)
    want = mxu_shard.shard_structures(s, S)
    got = rows_shard.shard_structures(structure_from_numpy(s), S)
    assert len(got) == len(want) == S
    for sh, (a, b) in enumerate(zip(got, want)):
        _fields_equal(a, b, (graph, S, sh))
        assert a.schur_native is None and np.array_equal(a.mono_perm, np.arange(a.mono.count))
    # the partition conserves every edge, slot and triplet
    assert sum(x.mono.count for x in got) == s.mono.count
    assert sum(x.n_hpl for x in got) == s.n_hpl
    assert sum(x.mul_i.shape[0] for x in got) == np.asarray(s.mul_i).shape[0]


def test_shard_structures_refuse_where_cuba_tpu_does():
    s, _ = _graph("g6f")
    port = structure_from_numpy(s)
    for S in (s.num_l + 1, 64):  # fewer active landmarks than shards
        assert mxu_shard.shard_structures(s, S) is None
        assert rows_shard.shard_structures(port, S) is None
    # one shard is the structure itself, with its C++ Schur plan
    assert rows_shard.shard_structures(port, 1)[0] is port


@pytest.mark.parametrize("graph,S,refused", [("g6f", 4, False), ("scattered", 4, False),
                                             ("g8", 16, True), ("g6e", 4, True),
                                             ("g6f", 64, True)])
def test_cut_shards_hold_cuba_tpus_shard_tables(graph, S, refused):
    """The one cut of both routes against ``cuba_tpu``'s padded AoS tables
    (``shard_problem``), also where its rows cut refuses (an empty shard):
    each shard's landmarks, edges, slots and triplets are the unpadded
    head of cuba_tpu's shard tables, in the same order."""
    s, _ = _graph(graph)
    want = tpu_sharding.shard_problem(s, S, jnp.float64)
    shards = rows_shard.cut_shards(structure_from_numpy(s), S)
    assert (mxu_shard.shard_structures(s, S) is None) == refused
    assert (rows_shard.shard_structures(structure_from_numpy(s), S) is None) == refused
    assert refused == (S > s.num_l or any(x.n_hpl == 0 for x in shards))
    c = want.consts
    n_fixed = s.total_l - s.num_l
    assert len(shards) == S
    for sh, x in enumerate(shards):
        assert x.num_l == -(-s.num_l // S) and x.total_l == x.num_l + n_fixed
        count = int(c.lm_count[sh])
        np.testing.assert_array_equal(x.Xws[:count], np.asarray(want.Xws)[sh, :count])
        np.testing.assert_array_equal(x.Xws[count:x.num_l], 0)
        np.testing.assert_array_equal(x.Xws[x.num_l:], np.asarray(s.Xws)[s.num_l:])
        for e in ("mono", "stereo"):
            ea, te = getattr(x, e), getattr(c, e)
            n = ea.count
            for f, tf in (("measurements", "meas"), ("omegas", "omega"),
                          ("pose_idx", "pose_idx"), ("lm_idx", "lm_idx")):
                np.testing.assert_array_equal(getattr(ea, f), np.asarray(getattr(te, tf))[sh, :n],
                                              err_msg=(e, f))
            assert not np.asarray(te.omega)[sh, n:].any()  # the rest is padding
        n = x.n_hpl
        for f in ("hpl_row", "hpl_col"):
            np.testing.assert_array_equal(getattr(x, f), np.asarray(getattr(c, f))[sh, :n])
        T = x.mul_i.shape[0]
        for f in ("mul_i", "mul_j", "mul_k"):
            np.testing.assert_array_equal(getattr(x, f), np.asarray(getattr(c, f))[sh, :T])
        assert (np.asarray(c.mul_k)[sh, T:] == s.n_hsc).all()
    assert sum(x.mono.count for x in shards) == s.mono.count
    assert sum(x.n_hpl for x in shards) == s.n_hpl


@pytest.mark.parametrize("graph,solver", [("g140", "band_cr"), ("loop", "band_lr"),
                                          ("g8", "dense_cholesky")])
def test_every_shard_plans_one_layout_of_the_all_reduced_table(graph, solver):
    """Each rank plans only its shard, so the all-reduced gT [36, M*Wg] must
    come out the same shape on every shard: the global pattern and the
    same pad_blocks fix M and Wg."""
    s = structure_from_numpy(_graph(graph)[0])
    cfg = cuba_tpu_torch.BAConfig(dtype=F64, solver=solver, device="cpu")
    solver, _m, PB, lr = engine.resolve_solver(s, cfg)
    plans = [rows.plan_row_tables(x, PB, lr)[0] for x in rows_shard.shard_structures(s, 4)]
    single = rows.plan_row_tables(s, PB, lr)[0]
    assert all(p is not None and p.v2 for p in plans)
    assert {(p.pad_blocks, p.wg, p.lr_nob, p.lr_k) for p in plans} == {
        (single.pad_blocks, single.wg, single.lr_nob, single.lr_k)}


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("graph,solver,want", [
    ("g8", "dense_cholesky", {"compact_to_dense"}),
    ("g140", "band_cr", {"compact_to_band"}),
    ("g8", "pcg", set()),
    ("scattered", "auto", None),
])
def test_route_facts_name_the_kernels_of_the_route(graph, solver, want):
    """The smoke's launch gate reads a rank's route facts
    (``drive.route_facts``) and names the route's kernels itself
    (``chip_smoke.expected_kernels``); the facts of an engine in this
    process give the kernels its route runs."""
    s, kernels = _graph(graph)
    eng = engine.BlockSolverEngine(structure_from_numpy(s), kernels,
                                   cuba_tpu_torch.BAConfig(dtype=F64, solver=solver,
                                                           device="cpu"))
    facts = drive.route_facts(eng)
    got = _chip_smoke().expected_kernels({k: np.array(v) for k, v in facts.items()})
    if want is None:
        assert facts["path"] == "aos" and got == {"accum_segsum"}
        return
    plan = eng.plan
    front = {"tiled_gather", "tiled_segsum",
             "windowed_gather" if plan.rg_m is not None else "resident_gather"}
    front |= {"accum_segsum_windowed" if p.ok else "accum_segsum"
              for p in (plan.paw_m, plan.paw_s, plan.paw_b)}
    schur = {"schur_fused"} if want else set()
    assert got == front | schur | want  # no trisolve kernels in fp64


def test_mesh_of_the_config():
    class FakeMesh:
        mesh_dim_names = ("landmarks",)

        def get_group(self, name):
            return ("group of", name)

    assert comm.group_of(None) is None
    assert comm.group_of(FakeMesh()) == ("group of", "landmarks")
    FakeMesh.mesh_dim_names = ("poses",)
    with pytest.raises(ValueError, match="landmarks"):
        comm.group_of(FakeMesh())
    group = object()
    assert comm.group_of(group) is group
    x = torch.arange(3.0)
    assert comm.all_reduce_sum(x, None) is x and comm.all_gather_rows(x, None) is x
    assert comm.size(None) == 1 and comm.rank(None) == 0 and comm.agree(True, None)


# ---------------------------------------------------------------------------
# trajectories against cuba_tpu's mesh engine
# ---------------------------------------------------------------------------


def _check_against(res, name, chis, lms, solver):
    got = res[0][f"{name}.chis"]
    assert str(res[0][f"{name}.solver"]) == solver
    n = min(len(got), len(chis))
    assert n >= 3 and len(got) == len(chis)
    np.testing.assert_allclose(got, chis, rtol=1e-6)
    num_l = lms.shape[0]
    np.testing.assert_allclose(res[0][f"{name}.Xws"][:num_l], lms, atol=1e-6)
    _same_on_every_rank(res, name)


@pytest.mark.parametrize("name", list(FP64_CASES))
def test_fp64_matches_cuba_tpu_mesh(ranks4, name):
    graph, solver = FP64_CASES[name]
    eng, chis, lms = _tpu_mesh_run(graph, solver)
    res = ranks4.result()
    _check_against(res, name, chis, lms, eng.solver)
    want_path = "aos" if graph in AOS_GRAPHS else ("rows" if solver == "pcg" else "v2")
    assert str(res[0][f"{name}.path"]) == want_path


def test_fp64_pcg_at_eight_shards_matches_cuba_tpu_mesh(ranks8):
    eng, chis, lms = _tpu_mesh_run("g12", "pcg", ndev=8)
    res = ranks8.result()
    assert len(res) == 8
    _check_against(res, "g12_pcg", chis, lms, "pcg")


def test_fp64_band_lr_matches_cuba_tpu_single_chip(ranks4):
    """cuba_tpu's fp64 mesh never takes band_lr (its rows body is fp32
    only), so the sharded band_lr is held to its single-chip fp64 engine,
    as tests/test_multichip_mxu.py:143 holds cuba_tpu's own."""
    s, kernels = _graph("loop")
    ref = tpu_engine.BlockSolverEngine(s, kernels, cuba_tpu.BAConfig(dtype=jnp.float64,
                                                                     mxu="off",
                                                                     solver="band_lr"))
    r = ref.optimize(None, 5)
    chis = np.asarray(r.chis)[:int(r.niters)]
    res = ranks4.result()
    assert str(res[0]["loop_band_lr.path"]) == "v2"
    _check_against(res, "loop_band_lr", chis, np.asarray(r.state.Xws)[:s.num_l], "band_lr")
    # without the rows route band_lr is an explicit dense_cholesky
    assert (str(res[0]["loop_band_lr_aos.path"]), str(res[0]["loop_band_lr_aos.solver"])) == (
        "aos", "dense_cholesky")
    np.testing.assert_allclose(res[0]["loop_band_lr_aos.chis"], chis, rtol=1e-6)


def test_fp32_matches_cuba_tpu_interpret_mesh(ranks4):
    eng, chis, lms = _tpu_mesh_run("g8", "dense_cholesky", iters=4, dtype=jnp.float32,
                                   mxu="interpret")
    assert eng.mxu_sp is not None
    res = ranks4.result()
    got = res[0]["g8_fp32.chis"]
    n = min(len(got), len(chis))
    assert n >= 3
    np.testing.assert_allclose(got[:n], chis[:n], rtol=5e-3)
    np.testing.assert_allclose(res[0]["g8_fp32.Xws"][:lms.shape[0]], lms, atol=5e-3)
    assert str(res[0]["g8_fp32.path"]) == "v2"
    _same_on_every_rank(res, "g8_fp32")


def test_aos_pcg_matches_single_device(ranks4):
    """The AoS body's sharded PCG (``ShardedSchurOperator``: one [P, 6]
    all-reduce a matvec) against the single-device AoS PCG."""
    s, kernels = _graph("g8")
    res = ranks4.result()
    assert (str(res[0]["g8_aos_pcg.path"]), str(res[0]["g8_aos_pcg.solver"])) == ("aos", "pcg")
    single = _single_aos("g8", "pcg")
    np.testing.assert_allclose(res[0]["g8_aos_pcg.chis"], single["chis"], rtol=1e-6)
    np.testing.assert_allclose(res[0]["g8_aos_pcg.Xws"], single["Xws"], atol=1e-6)
    _same_on_every_rank(res, "g8_aos_pcg")


@pytest.mark.parametrize("name", list(S1_CASES))
def test_one_shard_equals_the_single_device_engine_bit_for_bit(ranks4, name):
    res = ranks4.result()
    r = res[0]
    graph, solver, _dt, kw = S1_CASES[name]
    single = (_single_aos(graph, solver) if kw.get("aos") else
              {k: r[f"{name}.single.{k}"] for k in ("chis", "Xws", "qs", "ts", "final_lambda",
                                                     "nattempts")})
    for k in ("chis", "Xws", "qs", "ts", "final_lambda", "nattempts"):
        assert np.array_equal(r[f"{name}.{k}"], single[k]), (name, k)
    assert f"{name}.chis" not in res[1]  # rank 0 alone
    want = "aos" if "aos" in name or "scattered" in name else None
    if want:
        assert str(r[f"{name}.path"]) == want


# ---------------------------------------------------------------------------
# the public API, the state transfer and the launcher
# ---------------------------------------------------------------------------


def test_public_api_with_a_mesh_on_every_rank(ranks4):
    prob = synthetic.generate(num_poses=8, num_landmarks=64, seed=13)
    case = dict(problem=prob)
    ba = drive._graph(case, cuba_tpu_torch.BAConfig(dtype=F64, device="cpu"))
    ba.initialize()
    ba.optimize(5)
    chis = np.array([s.chi2 for s in ba.batch_statistics()])
    edges = list(ba._mono_edges) + list(ba._stereo_edges)
    res = ranks4.result()
    _same_on_every_rank(res, "api", ("chis", "pose_t", "pose_q", "lm_Xw", "chi_squared",
                                     "profiled_chis", "restored_Xw", "resumed_chis"))
    r = res[0]
    np.testing.assert_allclose(r["api.chis"], chis, rtol=1e-6)
    np.testing.assert_allclose(r["api.lm_Xw"],
                               np.stack([ba.landmark_vertex(j).Xw for j in sorted(ba._landmarks)]),
                               atol=1e-6)
    np.testing.assert_allclose(r["api.chi_squared"], [ba.chi_squared(e) for e in edges],
                               rtol=1e-6, atol=1e-9)
    # the time profile: the five loop phases of a plain run, attributed
    tp = dict(zip(r["api.profile_keys"].tolist(), r["api.profile_values"]))
    for k in engine.LOOP_PHASES:
        assert tp[k] > 0.0 and k in r["api.attributed"].tolist(), k
    # optimize(n, profile=True): the same trajectory as the plain run
    n = len(r["api.profiled_chis"])
    np.testing.assert_allclose(r["api.profiled_chis"], r["api.chis"][:n], rtol=1e-9)
    ptp = dict(zip(r["api.profiled_keys"].tolist(), r["api.profiled_values"]))
    assert ptp["6: Numerical Decomposition"] > 0 and ptp["3: Build System"] > 0
    # a checkpoint written on the mesh restores into a fresh graph
    np.testing.assert_array_equal(r["api.restored_Xw"], r["api.lm_Xw"])
    np.testing.assert_array_equal(r["api.restored_chis"], r["api.chis"])
    assert r["api.resumed_chis"][-1] <= r["api.chis"][-1]


def test_sharded_state_transfer(ranks4):
    """cuba_tpu's sharded landmarks to global order (``interop``) against
    the port's global state, and each rank's local array against the cut
    of that state: landmarks [r*base, (r+1)*base), zeros past the active
    ones, then the fixed tail (g6e's last shard holds padding only)."""
    res = ranks4.result()
    for name, graph in (("g6f_auto", "g6f"), ("g6e_auto", "g6e")):
        s, _ = _graph(graph)
        eng, _chis, lms = _tpu_mesh_run(graph, "auto")
        p = eng.problem
        full = interop.landmarks_from_sharded(p.Xws, p.lm_shard, p.lm_local, p.lm_pad_active,
                                              s.total_l - s.num_l)
        np.testing.assert_array_equal(full[:s.num_l], lms)
        np.testing.assert_array_equal(full[s.num_l:], np.asarray(s.Xws)[s.num_l:])
        glob = res[0][f"{name}.Xws"]
        np.testing.assert_allclose(glob, full, atol=1e-6)
        np.testing.assert_array_equal(res[0][f"{name}.gathered"], glob[:s.num_l])
        base = -(-s.num_l // 4)
        active = np.zeros((4 * base, 3))
        active[:s.num_l] = glob[:s.num_l]
        for r, out in enumerate(res):
            local = out[f"{name}.local_Xws"]
            np.testing.assert_array_equal(local[:base], active[r * base:(r + 1) * base])
            np.testing.assert_array_equal(local[base:], glob[s.num_l:])


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="KeyError"):
        launch.spawn(drive.run_cases, 2, device="cpu",
                     args=([dict(name="x", kind="no such kind")],), timeout=120)


def test_spawn_kills_ranks_past_their_time_limit():
    with pytest.raises(TimeoutError):
        launch.spawn(drive.run_cases, 2, device="cpu", args=([],), timeout=0.2)


def test_spawn_runs_on_the_card_by_default(monkeypatch):
    """spawn's device is the card unless the caller asks for the host;
    without a card the default raises before any rank starts, naming
    ``device="cpu"``."""
    import inspect

    assert inspect.signature(launch.spawn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(torch.multiprocessing, "get_context", lambda *a: started.append(a))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        launch.spawn(drive.run_cases, 2, args=([],), timeout=5)
    assert not started
