"""The port's symbolic pass and row planner against cuba_tpu's, bit for bit.

The port carries NumPy copies of cuba_tpu's host layer (cuba_tpu imports
JAX, which the card does not have).  These tests hold the copies to the
originals: the structure of ``build_structure_from_arrays`` and
``build_structure``, and the paddings, window plans, padded id tables and
``res_perm`` of ``plan_mxu(..., need_dense=False, wire_pack=False)``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cuba_tpu.io import synthetic as tpu_synthetic
from cuba_tpu.solver import mxu
from cuba_tpu.solver import structure as tpu_structure
from cuba_tpu_torch import native
from cuba_tpu_torch.interop import structure_from_numpy
from cuba_tpu_torch.io import synthetic
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


def _assert_structures_equal(port, ref):
    for f in dataclasses.fields(structure.BAStructure):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(a, structure.EdgeArrays):
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
    if name == "loop_band_perm":
        assert port.pose_rank is not None  # the band permutation ran


def test_numpy_symbolic_pass_matches(monkeypatch):
    """With no native library the port's NumPy pass gives cuba_tpu's tables."""
    args = _arrays(*PROBLEMS["fixed_landmarks"])
    ref = tpu_structure.build_structure_from_arrays(*args)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert native.backend() == "numpy"
    _assert_structures_equal(structure.build_structure_from_arrays(*args), ref)


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


def _assert_plan_equal(a, b, name):
    assert (a is None) == (b is None), name
    if a is None:
        return
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(np.asarray(getattr(a, f.name)),
                                      np.asarray(getattr(b, f.name)),
                                      err_msg=f"{name}.{f.name}")


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_row_plan_matches_plan_mxu(name):
    s = tpu_structure.build_structure_from_arrays(*_arrays(*PROBLEMS[name]))
    plans, consts = mxu.plan_mxu(s, need_dense=False, wire_pack=False)
    assert plans.ok and consts is not None
    plan, tables = rows.plan_row_tables(structure_from_numpy(s))
    for f in ("e_pad_m", "e_pad_s", "hpl_pad", "p_src_pad", "p_res_pad"):
        assert getattr(plan, f) == getattr(plans, f), f
    for f in ("hll_m", "hll_s", "hpl_m", "hpl_s", "ivs", "xpg", "cl", "xwg_m", "xwg_s",
              "paw_m", "paw_s", "paw_b", "rg_m", "rg_s"):
        _assert_plan_equal(getattr(plan, f), getattr(plans, f), f)
    assert set(tables) >= {"hpl_row", "hpl_col", "e2h_m", "pose_acc_m", "lm_gid_s"}
    for f, t in tables.items():
        assert t.dtype == np.int32, f
        np.testing.assert_array_equal(t, np.asarray(getattr(consts, f)), err_msg=f)
    _, rc = rows.plan_rows(structure_from_numpy(s), "cpu", torch.float32)
    for f in ("measT_m", "measT_s", "omegaT_m", "omegaT_s"):
        np.testing.assert_array_equal(getattr(rc, f).numpy(), getattr(consts, f), err_msg=f)
