"""The rest of the public API on the port, against cuba_tpu in the same run:
``chi_squared`` after graph edits, ``optimize(n, profile=True)``,
``time_profile`` / ``attributed_phases``, checkpoints, the JSON and BAL
readers, the SciPy oracle's copy, the three samples and the copied C++
symbolic pass.

Both packages run fp64 on the CPU (``cuba_tpu`` with x64 and ``mxu="off"``).
Tolerances: trajectories, ``final_lambda`` and per-edge chi² across the two
packages to 1e-6 relative (the bar of tests/test_parity.py); within one
package, and for copies of host code (structures, checkpoints, the oracle),
bit for bit.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuba_tpu
import cuba_tpu_torch
from cuba_tpu.io import bal as tpu_bal
from cuba_tpu.io import json_io as tpu_json_io
from cuba_tpu.io import synthetic as tpu_synthetic
from cuba_tpu.reference import solver as tpu_oracle
from cuba_tpu.solver import structure as tpu_structure
from cuba_tpu_torch import native
from cuba_tpu_torch.io import bal, json_io, synthetic
from cuba_tpu_torch.models.types import MonoEdge
from cuba_tpu_torch.reference import solver as oracle
from cuba_tpu_torch.solver import structure
from cuba_tpu_torch.solver.engine import LOOP_PHASES, PROFILE_ITEMS

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAL_TOY = os.path.join(REPO, "data", "bal_toy.txt.gz")
RTOL = 1e-6
FUSED = "optimize (fused device loop)"
INIT_PHASES = ("0: Initialize Optimizer", "1: Build Structure")
# ROADMAP queue 3's input: chi² of mono edges 1-5 after optimize(3), with
# and without the first mono edge removed
FAULT_VALUES = [0.906042, 1.519735, 0.175321, 0.489421, 0.131396]


def _config(pkg, **kw):
    if pkg is cuba_tpu:
        return cuba_tpu.BAConfig(dtype=jnp.float64, mxu="off", **kw)
    return cuba_tpu_torch.BAConfig(dtype=torch.float64, device="cpu", **kw)


def _syn(pkg):
    return tpu_synthetic if pkg is cuba_tpu else synthetic


def _graph(pkg, robust=False, config_kw=None, **gen):
    gen = {"num_poses": 12, "num_landmarks": 120, "seed": 3, **gen}
    syn = _syn(pkg)
    ba = syn.build_graph(syn.generate(**gen), _config(pkg, **(config_kw or {})))
    if robust:
        ba.set_robust_kernels(pkg.RobustKernelType.HUBER, float(np.sqrt(5.991)),
                              pkg.EdgeType.MONOCULAR)
        ba.set_robust_kernels(pkg.RobustKernelType.HUBER, float(np.sqrt(7.815)),
                              pkg.EdgeType.STEREO)
    return ba


def _chis(ba):
    return np.array([s.chi2 for s in ba.batch_statistics()])


# --- chi_squared ------------------------------------------------------------

def test_chi_squared_fault_input_gives_each_edge_its_own_value():
    """ROADMAP queue 3's input: after remove_edge of the first mono edge,
    the next five edges keep their own values; 0.0 before optimize()."""
    values = {}
    for pkg, edit in ((cuba_tpu_torch, True), (cuba_tpu_torch, False), (cuba_tpu, True)):
        ba = _graph(pkg)
        ba.initialize()
        mono = list(ba._mono_edges)
        assert ba.chi_squared(mono[0]) == 0.0 and ba.chi_squared(mono[7]) == 0.0
        ba.optimize(3)
        if edit:
            ba.remove_edge(mono[0])
        values[pkg.__name__, edit] = [ba.chi_squared(e) for e in mono[1:6]]
    port = values["cuba_tpu_torch", True]
    assert port == values["cuba_tpu_torch", False]  # exact: the edit shifts nothing
    assert [round(v, 6) for v in port] == FAULT_VALUES
    np.testing.assert_allclose(port, values["cuba_tpu", True], rtol=RTOL)


def _edit(pkg, ba, kind):
    mono = list(ba._mono_edges)
    if kind == "remove_edge":
        ba.remove_edge(mono[3])
    elif kind == "add_monocular_edge":
        e = mono[0]
        edge_type = MonoEdge if pkg is cuba_tpu_torch else cuba_tpu.MonoEdge
        ba.add_monocular_edge(edge_type(np.array([600.0, 180.0]), 1.0, e.vertexP,
                                        ba.landmark_vertex(e.vertexL.id + 1)))
    elif kind == "remove_landmark_vertex":
        ba.remove_landmark_vertex(mono[2].vertexL)
    else:
        mono[1].vertexL.fixed = True


@pytest.mark.parametrize("kind", ["remove_edge", "add_monocular_edge",
                                  "remove_landmark_vertex", "fixed"])
def test_chi_squared_after_edit_matches_cuba_tpu(kind):
    """An edit after optimize() leaves every edge's chi² as it was: the
    port's equal to its own unedited run bit for bit, and to cuba_tpu's
    after the same edit to 1e-6; an edge added after optimize() reads 0."""
    got = {}
    for pkg, edit in ((cuba_tpu_torch, True), (cuba_tpu_torch, False), (cuba_tpu, True)):
        ba = _graph(pkg, robust=True)
        ba.initialize()
        ba.optimize(3)
        edges = list(ba._mono_edges) + list(ba._stereo_edges)
        if edit:
            _edit(pkg, ba, kind)
        got[pkg.__name__, edit] = [ba.chi_squared(e) for e in edges]
        if edit and kind == "add_monocular_edge":
            assert ba.chi_squared(list(ba._mono_edges)[-1]) == 0.0
    port = got["cuba_tpu_torch", True]
    assert port == got["cuba_tpu_torch", False]
    assert all(v > 0 for v in port)
    np.testing.assert_allclose(port, got["cuba_tpu", True], rtol=RTOL, atol=1e-9)


def test_chi_squared_is_zero_after_clear_and_reinitialize():
    """clear() drops the table (cuba_tpu keeps the cleared edges' old values:
    a deliberate difference, ROADMAP queue 3); a new initialize() reads 0.0
    until its first optimize()."""
    ba = _graph(cuba_tpu_torch)
    ba.initialize()
    ba.optimize(2)
    e = list(ba._mono_edges)[0]
    assert ba.chi_squared(e) > 0
    ba.initialize()
    assert ba.chi_squared(e) == 0.0
    ba.optimize(2)
    assert ba.chi_squared(e) > 0
    ba.clear()
    assert ba.chi_squared(e) == 0.0


# --- optimize(n, profile=True) and final_lambda --------------------------------

# seed 2 with large initial noise: the profiled loop rejects attempts at
# iterations 6 and 8 (10 attempts for 8 iterations), far from convergence
REJECTING = dict(num_poses=8, num_landmarks=80, seed=2, init_rot_noise=0.3,
                 init_trans_noise=3.0, init_point_noise=3.0)


@pytest.mark.parametrize("case", ["accepts", "rejects"])
def test_profiled_matches_cuba_tpu(case):
    """The host-stepped driver against cuba_tpu's optimize_profiled: the
    trajectory and final_lambda to 1e-6, the same profile keys with the
    same zero phases (4 and 5)."""
    gen, robust, n = ((dict(), True, 6) if case == "accepts" else (REJECTING, False, 8))
    tba = _graph(cuba_tpu, robust, **gen)
    tba.initialize()
    want, _prof = tba._engine.optimize_profiled(None, n)
    want_chis = np.asarray(want.chis)[:int(want.niters)]

    ba = _graph(cuba_tpu_torch, robust, **gen)
    ba.initialize()
    ba.optimize(n, profile=True)
    r = ba.last_result
    np.testing.assert_allclose(_chis(ba), want_chis, rtol=RTOL)
    np.testing.assert_allclose(r.final_lambda, float(want.final_lambda), rtol=RTOL)
    assert r.niters == n
    if case == "rejects":
        assert r.nattempts > r.niters
    prof = ba.time_profile()
    assert tuple(prof) == PROFILE_ITEMS
    zero = {k for k, v in prof.items() if v == 0.0}
    assert zero == {"4: Schur Complement", "5: Symbolic Decomposition"}
    assert ba.attributed_phases() == set()


def test_fused_final_lambda_matches_cuba_tpu():
    tba = _graph(cuba_tpu, robust=True)
    tba.initialize()
    want = tba._engine.optimize(None, 5)
    ba = _graph(cuba_tpu_torch, robust=True)
    ba.initialize()
    ba.optimize(5)
    np.testing.assert_allclose(_chis(ba), np.asarray(want.chis)[:int(want.niters)], rtol=RTOL)
    np.testing.assert_allclose(ba.last_result.final_lambda, float(want.final_lambda),
                               rtol=RTOL)


# --- time_profile and attributed_phases (tests/test_profile.py's checks) --------

def _zero_and_nonzero(prof):
    return ({k for k, v in prof.items() if v == 0.0}, {k for k, v in prof.items() if v > 0})


def test_time_profile_attribution_matches_cuba_tpu():
    runs = {}
    for pkg in (cuba_tpu, cuba_tpu_torch):
        ba = _graph(pkg, num_poses=8, num_landmarks=60, seed=5)
        ba.initialize()
        ba.optimize(4)
        assert ba.attributed_phases() == set()  # nothing attributed until queried
        prof = dict(ba.time_profile())
        runs[pkg] = prof, ba.attributed_phases()
        again = ba.time_profile()  # idempotent: a second call adds nothing
        assert again["2: Compute Error"] == prof["2: Compute Error"]
    (tprof, tmarked), (prof, marked) = runs[cuba_tpu], runs[cuba_tpu_torch]
    assert set(prof) == set(tprof) == set(PROFILE_ITEMS) | {FUSED}
    assert marked == tmarked == set(LOOP_PHASES)
    assert _zero_and_nonzero(prof) == _zero_and_nonzero(tprof)
    assert prof["5: Symbolic Decomposition"] == 0.0
    assert sum(prof[k] for k in LOOP_PHASES) == pytest.approx(prof[FUSED], rel=1e-6)
    assert all(prof[k] > 0 for k in INIT_PHASES)


def test_time_profile_attribution_off_matches_cuba_tpu():
    profs = {}
    for pkg in (cuba_tpu, cuba_tpu_torch):
        ba = _graph(pkg, num_poses=6, num_landmarks=40, seed=9,
                    config_kw=dict(phase_attribution=False))
        ba.initialize()
        ba.optimize(3)
        profs[pkg] = dict(ba.time_profile())
        assert ba.attributed_phases() == set()
    assert ba._pending_attr == []  # the port records no marks at all
    prof, tprof = profs[cuba_tpu_torch], profs[cuba_tpu]
    assert set(prof) == set(tprof)
    assert _zero_and_nonzero(prof) == _zero_and_nonzero(tprof)
    assert prof["2: Compute Error"] == 0.0 and prof[FUSED] > 0


def test_time_profile_profiled_matches_cuba_tpu():
    """A profiled run measures every phase: nothing pending, nothing
    attributed, the same zero and non-zero keys as cuba_tpu; a plain run
    on the same graph after it is attributed once queried."""
    profs = {}
    for pkg in (cuba_tpu, cuba_tpu_torch):
        ba = _graph(pkg, num_poses=6, num_landmarks=40, seed=2)
        ba.initialize()
        ba.optimize(3, profile=True)
        profs[pkg] = dict(ba.time_profile())
        assert ba._pending_attr == [] and ba.attributed_phases() == set()
    prof, tprof = profs[cuba_tpu_torch], profs[cuba_tpu]
    assert tuple(prof) == PROFILE_ITEMS and set(tprof) == set(PROFILE_ITEMS)
    assert _zero_and_nonzero(prof) == _zero_and_nonzero(tprof)
    ba.optimize(2)
    assert ba.attributed_phases() == set()
    ba.time_profile()
    assert ba.attributed_phases() == set(LOOP_PHASES)


@pytest.mark.parametrize("solver", ["pcg", "band_cr", "band_lr", "dense_cholesky"])
def test_phase_marks_split_every_solver(solver):
    """Every solver marks all five loop phases; the split sums to the wall.
    (200 poses give four CR blocks; band_lr's two loop chords lie out of the
    band.)"""
    from chip_smoke import with_chords

    prob = synthetic.generate(num_poses=200, num_landmarks=1000, seed=1)
    if solver == "band_lr":
        prob = with_chords(prob, 2)
    ba = synthetic.build_graph(prob, cuba_tpu_torch.BAConfig(dtype=torch.float64,
                                                             device="cpu", solver=solver))
    ba.initialize()
    ba.optimize(2)
    prof = ba.time_profile()
    assert ba._engine.solver == solver
    assert all(prof[k] > 0 for k in LOOP_PHASES), prof
    assert sum(prof[k] for k in LOOP_PHASES) == pytest.approx(prof[FUSED], rel=1e-6)


# --- checkpoints ------------------------------------------------------------------

def _estimates(ba):
    return ([(v.id, tuple(v.q), tuple(v.t)) for v in ba._poses.values()],
            [(v.id, tuple(v.Xw)) for v in ba._landmarks.values()])


def _stats(ba):
    return [(s.iteration, s.chi2) for s in ba.batch_statistics()]


@pytest.mark.parametrize("writer", ["cuba_tpu", "cuba_tpu_torch"])
def test_checkpoint_loads_across_packages(tmp_path, writer):
    src_pkg, dst_pkg = ((cuba_tpu, cuba_tpu_torch) if writer == "cuba_tpu"
                        else (cuba_tpu_torch, cuba_tpu))
    src = _graph(src_pkg, robust=True)
    src.initialize()
    src.optimize(3)
    path = str(tmp_path / "ckpt.npz")
    src.save_checkpoint(path)
    dst = _graph(dst_pkg, robust=True)
    dst.loadCheckpoint(path)
    assert _estimates(dst) == _estimates(src)
    assert _stats(dst) == _stats(src) and len(_stats(dst)) == 3


def test_resumed_run_matches_cuba_tpu(tmp_path):
    src = _graph(cuba_tpu, robust=True)
    src.initialize()
    src.optimize(3)
    path = str(tmp_path / "ckpt.npz")
    src.saveCheckpoint(path)
    chis = {}
    for pkg in (cuba_tpu, cuba_tpu_torch):
        ba = _graph(pkg, robust=True)
        ba.load_checkpoint(path)
        ba.initialize()
        ba.optimize(4)
        chis[pkg] = _chis(ba)
    np.testing.assert_allclose(chis[cuba_tpu_torch], chis[cuba_tpu], rtol=RTOL)
    assert chis[cuba_tpu_torch][-1] < src.batch_statistics()[-1].chi2


def test_checkpoint_round_trip_restores_the_engine_state(tmp_path):
    ba = _graph(cuba_tpu_torch, robust=True)
    ba.initialize()
    ba.optimize(3)
    path = str(tmp_path / "ckpt.npz")
    ba.save_checkpoint(path)
    ba2 = _graph(cuba_tpu_torch, robust=True)
    ba2.load_checkpoint(path)
    assert _stats(ba2) == _stats(ba)
    ba2.initialize()
    assert ba2.batch_statistics() == []  # initialize() starts new statistics, as cuba_tpu
    for a, b in zip(ba2._engine.state, ba._state):
        assert torch.equal(a, b)
    assert ba.timeProfile is not None and ba.time_profile() is ba.timeProfile()


def test_load_checkpoint_reads_each_array_once(tmp_path, monkeypatch):
    """An NpzFile reads a key's whole array at every lookup, so a lookup per
    vertex (as cuba_tpu's loader makes) costs O(vertices x file); the port
    reads each of the file's seven arrays once."""
    ba = _graph(cuba_tpu_torch)
    path = str(tmp_path / "ckpt.npz")
    ba.save_checkpoint(path)
    reads, real = [], np.load

    class Counting:
        def __init__(self, f):
            self.f, self.files = f, f.files

        def __getitem__(self, key):
            reads.append(key)
            return self.f[key]

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.f.close()

    monkeypatch.setattr(np, "load", lambda p: Counting(real(p)))
    again = _graph(cuba_tpu_torch)
    again.load_checkpoint(path)
    assert sorted(reads) == sorted(["pose_ids", "qs", "ts", "lm_ids", "Xws", "stats_iter",
                                    "stats_chi2"])
    assert _estimates(again) == _estimates(ba)


# --- JSON and BAL ---------------------------------------------------------------

def _structure(pkg, ba):
    build = (tpu_structure if pkg is cuba_tpu else structure).build_structure
    return build(sorted(ba._poses), ba._poses, sorted(ba._landmarks), ba._landmarks,
                 ba._mono_edges, ba._stereo_edges)


def _assert_structures_equal(a, b):
    for f in dataclasses.fields(structure.BAStructure):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, structure.EdgeArrays):
            for g in ("measurements", "omegas", "pose_idx", "lm_idx"):
                np.testing.assert_array_equal(getattr(x, g), getattr(y, g),
                                              err_msg=f"{f.name}.{g}")
        elif f.name == "schur_native" and x is not None:
            for k, (u, v) in enumerate(zip(x[1:], y[1:])):
                np.testing.assert_array_equal(np.asarray(u), np.asarray(v), err_msg=str(k))
        elif x is None or y is None:
            assert x is None and y is None, f.name
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f.name)


@pytest.mark.parametrize("writer", ["cuba_tpu", "cuba_tpu_torch"])
def test_json_reads_into_equal_structures(tmp_path, writer):
    """A file either package writes reads into equal BAStructure arrays in
    both, and equal to the written graph's (json round-trips float64)."""
    src_pkg = cuba_tpu if writer == "cuba_tpu" else cuba_tpu_torch
    src = _graph(src_pkg, seed=4)
    src.landmark_vertex(5).fixed = True
    path = str(tmp_path / "graph.json")
    (tpu_json_io if src_pkg is cuba_tpu else json_io).write_graph(src, path)
    port = json_io.read_graph(path, _config(cuba_tpu_torch))
    ref = tpu_json_io.read_graph(path, _config(cuba_tpu))
    assert port.nedges() == src.nedges() and port.landmark_vertex(5).fixed
    s_port = _structure(cuba_tpu_torch, port)
    _assert_structures_equal(s_port, _structure(cuba_tpu, ref))
    _assert_structures_equal(s_port, _structure(src_pkg, src))
    # and the file the port writes back is the same file
    json_io.write_graph(port, str(tmp_path / "again.json"))
    assert (json.load(open(tmp_path / "again.json")) == json.load(open(path)))


def test_bal_reads_into_equal_structures():
    ba = bal.read_bal(BAL_TOY, _config(cuba_tpu_torch))
    tba = tpu_bal.read_bal(BAL_TOY, _config(cuba_tpu))
    assert (ba.nposes(), ba.nlandmarks(), ba.nedges()) == (20, 500, tba.nedges())
    assert ba.pose_vertex(0).fixed and not ba.pose_vertex(1).fixed
    _assert_structures_equal(_structure(cuba_tpu_torch, ba), _structure(cuba_tpu, tba))


def test_bal_trajectory_matches_cuba_tpu_and_the_oracle():
    ba = bal.read_bal(BAL_TOY, _config(cuba_tpu_torch))
    ba.initialize()
    ref = oracle.ReferenceSolver(oracle.RefProblem.from_structure(ba._engine.structure,
                                                                  ba._kernels))
    ba.optimize(6)
    got = _chis(ba)
    tba = tpu_bal.read_bal(BAL_TOY, _config(cuba_tpu))
    tba.initialize()
    tba.optimize(6)
    want = _chis(tba)
    chis_ref = np.array(ref.optimize(6))
    n = min(len(got), len(want), len(chis_ref))
    assert n >= 4 and got[-1] < got[0]
    np.testing.assert_allclose(got[:n], want[:n], rtol=RTOL)
    np.testing.assert_allclose(got[:n], chis_ref[:n], rtol=RTOL)


def test_bal_write_round_trip(tmp_path):
    ba = bal.read_bal(BAL_TOY, _config(cuba_tpu_torch))
    out = str(tmp_path / "rt.txt")
    bal.write_bal(ba, out)
    ba2 = bal.read_bal(out, _config(cuba_tpu_torch))
    tba2 = tpu_bal.read_bal(out, _config(cuba_tpu))
    assert (ba2.nposes(), ba2.nedges()) == (ba.nposes(), ba.nedges())
    for pid in sorted(ba._poses):
        v, v2 = ba.pose_vertex(pid), ba2.pose_vertex(pid)
        sign = np.sign(np.dot(v.q, v2.q)) or 1.0  # q and -q are one rotation
        np.testing.assert_allclose(sign * v2.q, v.q, atol=1e-12)
        np.testing.assert_allclose(v2.t, v.t, atol=1e-12)
        assert v2.camera.fx == v.camera.fx
    m = sorted(tuple(e.measurement) for e in ba._mono_edges)
    m2 = sorted(tuple(e.measurement) for e in ba2._mono_edges)
    np.testing.assert_allclose(m, m2, atol=1e-9)
    _assert_structures_equal(_structure(cuba_tpu_torch, ba2), _structure(cuba_tpu, tba2))


def _write_bal(path, k1):
    """Two cameras and three points, every point seen by both."""
    cams = [[0.01, -0.02, 0.03, 0.1, -0.2, -8.0, 500.0, k1, 0.0],
            [-0.02, 0.01, 0.0, -0.3, 0.1, -9.0, 520.0, k1, 0.0]]
    pts = [[0.5, -0.5, 1.0], [-1.0, 0.2, 0.0], [0.3, 0.8, -0.7]]
    lines = ["2 3 6"] + [f"{i} {j} {10.0 * (i + j)} {-5.0 * j}"
                         for i in range(2) for j in range(3)]
    lines += [str(x) for c in cams for x in c] + [str(x) for p in pts for x in p]
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("case", ["token count", "distortion", "camera index"])
def test_bal_error_paths(tmp_path, case):
    p = tmp_path / "bad.txt"
    kw = {}
    if case == "token count":
        p.write_text("2 1 1\n0 0 1.0 2.0\n" + "0\n" * 9)  # promises 2 cams, has 1
    elif case == "distortion":
        _write_bal(p, k1=-0.05)
        kw = dict(undistort=False)
    else:
        _write_bal(p, k1=0.0)
        p.write_text(p.read_text().replace("\n1 2 30.0", "\n7 2 30.0", 1))
    for read in (bal.read_bal, tpu_bal.read_bal):
        with pytest.raises(ValueError, match=case):
            read(str(p), **kw)
    if case == "distortion":  # with undistortion it loads, as cuba_tpu's does
        ba = bal.read_bal(str(p), _config(cuba_tpu_torch))
        tba = tpu_bal.read_bal(str(p), _config(cuba_tpu))
        _assert_structures_equal(_structure(cuba_tpu_torch, ba), _structure(cuba_tpu, tba))


# --- the oracle's copy --------------------------------------------------------------

@pytest.mark.parametrize("robust", [False, True])
def test_oracle_copy_equals_cuba_tpu_bit_for_bit(robust):
    ba = _graph(cuba_tpu_torch, robust=robust, num_poses=8, num_landmarks=70, seed=6)
    ba.initialize()
    s = ba._engine.structure
    out = []
    for mod in (oracle, tpu_oracle):
        solver = mod.ReferenceSolver(mod.RefProblem.from_structure(s, ba._kernels))
        chis = solver.optimize(5)
        out.append((chis, solver.p.qs, solver.p.ts, solver.p.Xws))
    (c1, *a1), (c2, *a2) = out
    assert c1 == c2 and len(c1) == 5
    for x, y in zip(a1, a2):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(out[0][3], s.Xws)  # it moved the estimates


# --- the samples ------------------------------------------------------------------

def _printed_chis(text):
    chis = [float(line.split("=")[1]) for line in text.splitlines()
            if line.startswith("iter ") and "chi2 =" in line]
    if not chis:  # the comparison's table: "i | port | ref | rel"
        chis = [float(line.split("|")[1]) for line in text.splitlines()
                if line.strip()[:1].isdigit() and "|" in line]
    return np.array(chis)


@pytest.mark.parametrize("name", ["ba_from_file", "ba_from_file --profiled", "bal",
                                  "comparison_with_reference"])
def test_sample_runs_on_the_cpu(tmp_path, capsys, name):
    from cuba_tpu_torch.samples import (sample_ba_from_file, sample_bal,
                                        sample_comparison_with_reference)

    if name.startswith("ba_from_file"):
        path = str(tmp_path / "graph.json")
        json_io.write_graph(_graph(cuba_tpu_torch, num_poses=10, num_landmarks=100), path)
        sample_ba_from_file.main([path, "--iters", "4", "--cpu", *name.split()[1:]])
    elif name == "bal":
        sample_bal.main([BAL_TOY, "--iters", "4", "--cpu"])
    else:
        sample_comparison_with_reference.main(["--poses", "10", "--landmarks", "100",
                                               "--iters", "4", "--cpu"])
    out = capsys.readouterr().out
    chis = _printed_chis(out)
    assert len(chis) == 4 and np.all(np.isfinite(chis)) and np.all(np.diff(chis) < 0), out
    if name == "ba_from_file":
        assert "3: Build System" in out and " *" in out
    if name == "ba_from_file --profiled":
        assert " *" not in out
    if name == "comparison_with_reference":
        rel = [float(line.split("|")[3]) for line in out.splitlines()
               if line.strip()[:1].isdigit() and "|" in line]
        assert max(rel) < RTOL


def test_sample_fp64_on_the_card_is_refused_not_moved():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from cuba_tpu_torch.samples import sample_ba_from_file

    with pytest.raises(RuntimeError, match='device="cpu"'):
        sample_ba_from_file.main(["--synthetic", "--poses", "6", "--landmarks", "40",
                                  "--iters", "2", "--fp64"])


# --- the C++ symbolic pass -------------------------------------------------------------

def test_symbolic_source_is_the_ports_own_copy():
    here = os.path.join(REPO, "cuba_tpu_torch", "csrc", "symbolic.cpp")
    assert os.path.samefile(native.SRC, here)
    with open(here, "rb") as a, open(os.path.join(REPO, "cuba_tpu", "native",
                                                  "symbolic.cpp"), "rb") as b:
        assert a.read() == b.read()
    assert native.BUILD_DIR == os.path.join(REPO, "cuba_tpu_torch", "_build")
