"""The port's symbolic pass and row planner against cuba_tpu's, bit for bit.

The port carries NumPy copies of cuba_tpu's host layer (cuba_tpu imports
JAX, which the card does not have).  These tests hold the copies to the
originals: the structure of ``build_structure_from_arrays`` and
``build_structure`` (the Schur pattern, triplets and the C++ pass's fused
Schur plan included), ``plan_schur`` through the C++ and the NumPy paths,
and the id tables of ``plan_mxu(..., wire_pack=False)`` on their valid
prefix, with and without the Schur plan, ``wg`` and the v2 band and dense
tables (``need_dense``), and the placement table of ``compact_to_dense``.
The port pads for the card (each per-edge and per-slot table to a multiple
of 1024, and -1 beyond the valid prefix), not for the TPU's window and
tile plans, which it does not carry.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cuba_tpu import native as tpu_native
from cuba_tpu.io import synthetic as tpu_synthetic
from cuba_tpu.ops import segmm as tpu_segmm
from cuba_tpu.solver import engine as tpu_engine
from cuba_tpu.solver import mxu
from cuba_tpu.solver import structure as tpu_structure
from cuba_tpu_torch import native
from cuba_tpu_torch.interop import structure_from_numpy
from cuba_tpu_torch.io import synthetic
from cuba_tpu_torch.ops import segmm
from cuba_tpu_torch.solver import rows
from cuba_tpu_torch.solver import structure

torch.set_num_threads(1)

# (num_poses, num_landmarks, seed, loop_closure, fixed landmark stride)
PROBLEMS = {
    "small": (10, 90, 5, False, 0),
    "fixed_landmarks": (24, 300, 3, False, 7),
    "loop_band_perm": (160, 1500, 2, True, 0),
}


def _arrays(num_p, num_l, seed, loop, fix_stride):
    prob = tpu_synthetic.generate(num_poses=num_p, num_landmarks=num_l, seed=seed,
                                  loop_closure=loop)
    fp = np.zeros(num_p, bool)
    fp[prob.fixed_poses] = True
    fl = np.zeros(num_l, bool)
    if fix_stride:
        fl[::fix_stride] = True
    return (prob.qs, prob.ts, np.tile(prob.cam, (num_p, 1)), prob.Xws, fp, fl,
            prob.mono_p, prob.mono_l, prob.mono_z, prob.mono_w,
            prob.stereo_p, prob.stereo_l, prob.stereo_z, prob.stereo_w)


def _assert_structures_equal(port, ref, skip=()):
    for f in dataclasses.fields(structure.BAStructure):
        if f.name in skip:
            continue
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "schur_native" and a is not None and b is not None:
            assert a[0] == b[0] and len(a) == len(b)
            for k, (x, y) in enumerate(zip(a[1:], b[1:])):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                              err_msg=f"schur_native[{k + 1}]")
        elif isinstance(a, structure.EdgeArrays):
            for g in ("measurements", "omegas", "pose_idx", "lm_idx"):
                x, y = getattr(a, g), getattr(b, g)
                assert x.dtype == y.dtype, (f.name, g)
                np.testing.assert_array_equal(x, y, err_msg=f"{f.name}.{g}")
        elif a is None or b is None:
            assert a is None and b is None, f.name
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f.name)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_structure_from_arrays_matches(name):
    args = _arrays(*PROBLEMS[name])
    port = structure.build_structure_from_arrays(*args)
    ref = tpu_structure.build_structure_from_arrays(*args)
    _assert_structures_equal(port, ref)
    assert port.n_hsc > 0 and port.mul_i.size > 0
    assert (port.schur_native is None) == (native.backend() == "numpy")
    if name == "loop_band_perm":
        assert port.pose_rank is not None  # the band permutation ran


def test_numpy_symbolic_pass_matches(monkeypatch):
    """With no native library the port's NumPy pass gives cuba_tpu's tables."""
    args = _arrays(*PROBLEMS["fixed_landmarks"])
    ref = tpu_structure.build_structure_from_arrays(*args)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert native.backend() == "numpy"
    port = structure.build_structure_from_arrays(*args)
    # the NumPy pass emits no fused Schur plan: plan_schur makes it
    # (test_schur_plan_matches)
    assert port.schur_native is None
    _assert_structures_equal(port, ref, skip=("schur_native",))


def test_object_graph_structure_matches():
    from cuba_tpu.io import synthetic as tsyn

    prob = synthetic.generate(num_poses=12, num_landmarks=120, seed=3)
    ba = synthetic.build_graph(prob)
    tba = tsyn.build_graph(tsyn.generate(num_poses=12, num_landmarks=120, seed=3))

    def compile_(g, build):
        return build(sorted(g._poses), g._poses, sorted(g._landmarks), g._landmarks,
                     g._mono_edges, g._stereo_edges)

    port = compile_(ba, structure.build_structure)
    ref = compile_(tba, tpu_structure.build_structure)
    _assert_structures_equal(port, ref)
    assert [v.iP for v in ba._poses.values()] == [v.iP for v in tba._poses.values()]
    assert [v.iL for v in ba._landmarks.values()] == [v.iL for v in tba._landmarks.values()]


def _pad(n: int) -> int:
    return max(-(-n // 1024) * 1024, 1024)


def _assert_paddings(plan, s, schur=None):
    """The card's paddings: each edge type's and the slots' count rounded
    up to 1024 (at least 1024), the slots' at least schur_fused's window."""
    assert plan.e_pad_m == _pad(s.mono.count) and plan.e_pad_s == _pad(s.stereo.count)
    assert plan.hpl_pad == max(_pad(s.n_hpl), schur.n_slot_pad if schur else 0)


def _assert_tables_match(tables, consts):
    """Every table equal to plan_mxu's on the valid prefix and -1 beyond
    it: the prefix is the shorter table (cuba_tpu's tile plans may pad
    further than the card, and every valid entry lies within both)."""
    for f, t in tables.items():
        ref = np.asarray(getattr(consts, f))
        assert t.dtype == np.int32, f
        n = min(t.size, ref.size)
        np.testing.assert_array_equal(t[:n], ref[:n], err_msg=f)
        assert np.all(t[n:] == -1) and np.all(ref[n:] == -1), f


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_row_plan_matches_plan_mxu(name):
    s = tpu_structure.build_structure_from_arrays(*_arrays(*PROBLEMS[name]))
    plans, consts = mxu.plan_mxu(s, need_dense=False, wire_pack=False)
    assert plans.ok and consts is not None
    port_s = structure_from_numpy(s)
    plan, tables = rows.plan_row_tables(port_s)
    _assert_paddings(plan, port_s)
    assert plan.schur is None and not plan.v2
    assert set(tables) == {"pose_gid_m", "pose_gid_s", "lm_gid_m", "lm_gid_s", "pose_acc_m",
                           "pose_acc_s", "lm_acc_m", "lm_acc_s", "e2h_m", "e2h_s", "hpl_row",
                           "hpl_col"}
    for f, t in tables.items():
        assert t.size == (plan.hpl_pad if f.startswith("hpl") else
                          plan.e_pad_m if f.endswith("_m") else plan.e_pad_s), f
    _assert_tables_match(tables, consts)
    _, rc = rows.plan_rows(port_s, "cpu", torch.float32)
    for f, E in (("measT_m", s.mono.count), ("measT_s", s.stereo.count),
                 ("omegaT_m", s.mono.count), ("omegaT_s", s.stereo.count)):
        got, want = getattr(rc, f).numpy(), np.asarray(getattr(consts, f))
        np.testing.assert_array_equal(got[..., :E], want[..., :E], err_msg=f)
        assert not got[..., E:].any() and not want[..., E:].any(), f


def _assert_schur_plans_equal(a, b, name):
    for f in dataclasses.fields(segmm.SchurPlan):
        np.testing.assert_array_equal(np.asarray(getattr(a, f.name)),
                                      np.asarray(getattr(b, f.name)),
                                      err_msg=f"{name}.{f.name}")


@pytest.mark.parametrize("path", ["c++", "numpy"])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_schur_plan_matches(name, path, monkeypatch):
    """plan_schur through the C++ pass's plan and through the NumPy planner
    (no library on either side) gives cuba_tpu's plan of the same path."""
    args = _arrays(*PROBLEMS[name])
    ref_s = tpu_structure.build_structure_from_arrays(*args)
    if path == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
        monkeypatch.setattr(tpu_native, "schur_plan", lambda *a, **k: None)
        ref_s.schur_native = None
    elif native.backend() == "numpy":
        pytest.skip("no g++: the C++ symbolic pass is not built")
    s = structure.build_structure_from_arrays(*args)
    assert segmm.SC_GEOMETRY == tpu_segmm.sc_geometry()
    _assert_schur_plans_equal(rows.plan_schur_for(s), mxu.plan_schur_for(ref_s), name)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_band_plan_matches_plan_mxu(name):
    """The v2 band formation's plans and tables (need_dense=True) and the
    paddings they move, bit for bit."""
    s = tpu_structure.build_structure_from_arrays(*_arrays(*PROBLEMS[name]))
    PB = tpu_engine._pad_blocks(s.num_p)
    assert rows.pad_blocks_of(s.num_p) == PB
    plans, consts = mxu.plan_mxu(s, PB, need_dense=True, wire_pack=False)
    assert plans.ok and plans.v2 and consts is not None
    port_s = structure_from_numpy(s)
    plan, tables = rows.plan_row_tables(port_s, PB)
    assert plan.v2 and plan.wg == plans.wg and plan.pad_blocks == PB
    _assert_schur_plans_equal(plan.schur, plans.schur, name)
    _assert_paddings(plan, port_s, plan.schur)
    assert set(tables) >= {"gkey_up2", "iru", "icu", "occ2", "band_occ", "sc_sb", "sc_li",
                           "sc_lj", "sc_lk", "hpl_row", "e2h_m"}
    for f in ("gkey_up2", "iru", "icu", "occ2", "band_occ", "sc_sb", "sc_li", "sc_lj",
              "sc_lk"):  # the Schur formation's tables come whole
        assert tables[f].size == np.asarray(getattr(consts, f)).size, f
    _assert_tables_match(tables, consts)
    _, rc = rows.plan_rows(port_s, "cpu", torch.float32, pad_blocks=PB)
    # the combine's keys: one a schur_fused output lane, no padding
    assert rc.gkey_up2.shape[0] == plan.schur.num_chunks * plan.schur.kwin
    np.testing.assert_array_equal(rc.gkey_up2.numpy(), tables["gkey_up2"])


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_dense_table_places_every_block(name):
    """compact_to_dense's placement table: every Hsc block at (row, col),
    its transposed mirror at (col, row) off the diagonal, nothing else; and
    occ2 marks every tile the table or the diagonal writes."""
    s = structure_from_numpy(tpu_structure.build_structure_from_arrays(
        *_arrays(*PROBLEMS[name])))
    PB = rows.pad_blocks_of(s.num_p)
    plan, rc = rows.plan_rows(s, "cpu", torch.float32, pad_blocks=PB, dense=True)
    tab = rc.dense_table.numpy()
    iru, icu = rc.iru.numpy(), rc.icu.numpy()
    assert tab.shape == (PB, PB) and tab.dtype == np.int32
    slots = np.flatnonzero(iru >= 0)
    r, c = iru[slots], icu[slots]
    assert slots.size == s.n_hsc and np.all(r <= c)
    np.testing.assert_array_equal(tab[r, c], slots)
    off = r != c
    np.testing.assert_array_equal(tab[c[off], r[off]], slots[off] | (1 << 30))
    assert int((tab >= 0).sum()) == slots.size + int(off.sum())
    occ = rc.occ2.numpy().reshape(PB // 64, PB // 128)
    p, q = np.nonzero(tab >= 0)
    assert occ[p // 64, q // 128].all()
    d = np.arange(PB)
    assert occ[d // 64, d // 128].all()
    # without dense=True the table is not built
    assert rows.plan_rows(s, "cpu", torch.float32, pad_blocks=PB)[1].dense_table is None
