"""The v1 Schur formation, kernel 10 (``band_transpose``) and the planner's
route, against cuba_tpu on the CPU.

Both packages form the dense Schur matrix with their v1 formation (two
combines into the dense block table [36, PB*PB], then ``band_transpose``)
only where the v2 band-major formation does not plan: where a 64-row band
holds more than ``_WG_MAX`` Hsc blocks.  Of the graphs the repo generates
only the scattered and wide ones below get there on their own, and only in
the port (cuba_tpu's window plans send them to its XLA path), so these
tests close the v2 gate on both sides with ``monkeypatch`` (``_WG_MAX = 0``
in ``cuba_tpu.solver.mxu`` and in ``cuba_tpu_torch.solver.rows``), as the
chip check does.

- ``band_transpose``'s plain twin against the Pallas kernel in interpret mode:
  a copy, so bit for bit.  The Pallas kernel splits the values into bf16
  parts, which is exact for normal floats; the inputs are standard normal
  draws, with no subnormals.
- The v1 tables against ``plan_mxu``'s, bit for bit.
- The v1 dense matrix against ``schur_dense_mxu`` in interpret mode (1e-5:
  fp32 sums in other orders) and against the port's own v2 matrix (bit for
  bit: the same window lanes are summed in the same order).
- LM trajectories through v1: fp32 against cuba_tpu's interpret path (5e-3,
  the path-against-path bar of tests/test_mxu_path.py) and fp64 against its
  XLA path (1e-6, the bar of tests/test_parity.py).
- The route (v2, v1 or none: the AoS path) on scattered, wide-band,
  loop-chord, pose-only and landmark-only graphs: the port's own rule,
  cuba_tpu's route wherever the TPU's window plans hold, and on the
  scattered and wide graphs (v1 in the port, the XLA path in cuba_tpu) the
  fp64 trajectory within 1e-6 of cuba_tpu's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuba_tpu
import cuba_tpu_torch
from cuba_tpu.io import synthetic as tpu_synthetic
from cuba_tpu.ops import segmm as tpu_segmm
from cuba_tpu.solver import engine as tpu_engine
from cuba_tpu.solver import mxu
from cuba_tpu.solver import structure as tpu_structure
from cuba_tpu_torch.interop import structure_from_numpy
from cuba_tpu_torch.io import synthetic
from cuba_tpu_torch.ops import segmm
from cuba_tpu_torch.solver import band_cr, engine, rows

torch.set_num_threads(1)

MONO_DELTA = float(np.sqrt(5.991))


@pytest.fixture
def v2_gate_closed(monkeypatch):
    monkeypatch.setattr(mxu, "_WG_MAX", 0)
    monkeypatch.setattr(rows, "_WG_MAX", 0)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# kernel 10
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("PB", [128, 256])
def test_band_transpose_plain_matches_pallas(PB):
    rng = np.random.default_rng(PB)
    m4 = rng.standard_normal((36, PB, PB)).astype(np.float32)
    occ = (rng.random((PB // 64, PB // 128)) < 0.5).astype(np.int32)
    occ[0, 0] = 1
    occ[-1, -1] = 0
    want = np.asarray(tpu_segmm.band_transpose(jnp.asarray(m4), jnp.asarray(occ.reshape(-1)),
                                               PB, interpret=True))
    got = segmm.band_transpose(_t(m4), _t(occ.reshape(-1)), PB).numpy()
    np.testing.assert_array_equal(got, want)
    # the relayout itself: element (6p+i, 6q+j) of an occupied tile is m4[i*6+j, p, q]
    p, q, i, j = 5, 7, 2, 3
    assert got[6 * p + i, 6 * q + j] == m4[i * 6 + j, p, q]
    assert not got[6 * (PB - 1):, 6 * (PB - 1):].any()


@pytest.mark.parametrize("case", ["m4", "occ"])
def test_band_transpose_refuses_input_that_does_not_fit(case):
    PB = 128
    m4 = torch.zeros((36, PB, PB))
    occ = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="does not fit"):
        if case == "m4":
            segmm.band_transpose(m4[:, :, :-1], occ, PB)
        else:
            segmm.band_transpose(m4, occ[:1], PB)


# ---------------------------------------------------------------------------
# the v1 plans and formation
# ---------------------------------------------------------------------------


def _tpu_structure(num_p, num_l, seed):
    prob = tpu_synthetic.generate(num_poses=num_p, num_landmarks=num_l, seed=seed)
    fp = np.zeros(num_p, bool)
    fp[prob.fixed_poses] = True
    return tpu_structure.build_structure_from_arrays(
        prob.qs, prob.ts, np.tile(prob.cam, (num_p, 1)), prob.Xws, fp, np.zeros(num_l, bool),
        prob.mono_p, prob.mono_l, prob.mono_z, prob.mono_w,
        prob.stereo_p, prob.stereo_l, prob.stereo_z, prob.stereo_w)


@pytest.fixture(params=[(10, 90, 7), (150, 1400, 2)], ids=["small", "banded"])
def v1_plan(request, v2_gate_closed):
    s = _tpu_structure(*request.param)
    PB = tpu_engine._pad_blocks(s.num_p)
    plans, consts = mxu.plan_mxu(s, PB, need_dense=True, wire_pack=False)
    assert plans.ok and not plans.v2
    plan, rc = rows.plan_rows(structure_from_numpy(s), "cpu", torch.float32, pad_blocks=PB)
    assert not plan.v2
    return s, PB, plans, consts, plan, rc


def test_v1_plans_match_plan_mxu(v1_plan):
    s, PB, plans, consts, plan, rc = v1_plan
    _, tables = rows.plan_row_tables(structure_from_numpy(s), PB)
    for name in ("gkey_up", "gkey_lo", "occ"):
        np.testing.assert_array_equal(tables[name], getattr(consts, name), err_msg=name)
    # the combines' keys: one a schur_fused output lane, no padding
    n_win = plans.schur.num_chunks * plans.schur.kwin
    assert plan.schur.num_chunks * plan.schur.kwin == n_win
    for keys, csr in ((rc.gkey_up, rc.csr_up), (rc.gkey_lo, rc.csr_lo)):
        assert tuple(keys.shape) == (n_win,) and csr.offs.shape[0] == PB * PB + 1


def _formation_inputs(plan, num_p):
    rng = np.random.default_rng(5)
    H = plan.hpl_pad
    W = (rng.standard_normal((18, H)) * 0.3).astype(np.float32)
    G = (rng.standard_normal((18, H)) * 0.3).astype(np.float32)
    HppT = rng.standard_normal((42, num_p)).astype(np.float32)
    return W, G, HppT, np.float32(1e-3)


def test_v1_dense_matches_schur_dense_mxu_and_v2(v1_plan, monkeypatch):
    s, PB, plans, consts, plan, rc = v1_plan
    W, G, HppT, lam = _formation_inputs(plan, s.num_p)
    mc = jax.tree_util.tree_map(jnp.asarray, consts)
    want = mxu.schur_dense_mxu(jnp.asarray(HppT), jnp.asarray(W), jnp.asarray(G), lam,
                               s.num_p, PB, plans, mc, jnp.float32, interpret=True)
    got = rows.schur_dense(_t(HppT), _t(W), _t(G), torch.tensor(lam), s.num_p, plan, rc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the v2 formation of the same structure, gate open
    monkeypatch.setattr(rows, "_WG_MAX", 2048)
    plan2, rc2 = rows.plan_rows(structure_from_numpy(s), "cpu", torch.float32, pad_blocks=PB,
                                dense=True)
    assert plan2.v2 and plan2.hpl_pad == plan.hpl_pad
    got2 = rows.schur_dense(_t(HppT), _t(W), _t(G), torch.tensor(lam), s.num_p, plan2, rc2)
    np.testing.assert_array_equal(got.numpy(), got2.numpy())


# ---------------------------------------------------------------------------
# LM trajectories through v1
# ---------------------------------------------------------------------------


def _run(pkg, syn, config, niters=6):
    ba = syn.build_graph(syn.generate(num_poses=10, num_landmarks=90, seed=7), config)
    ba.set_robust_kernels(pkg.RobustKernelType.HUBER, MONO_DELTA, pkg.EdgeType.MONOCULAR)
    ba.initialize()
    ba.optimize(niters)
    return ba, np.array([s.chi2 for s in ba.batch_statistics()])


@pytest.mark.parametrize("solver", ["band_cr", "dense_cholesky"])
def test_fp32_v1_trajectory_matches_interpret_path(v2_gate_closed, solver):
    tba, want = _run(cuba_tpu, tpu_synthetic,
                     cuba_tpu.BAConfig(dtype=jnp.float32, mxu="interpret", solver=solver))
    assert tba._engine.use_mxu and not tba._engine.mxu_plans.v2
    ba, got = _run(cuba_tpu_torch, synthetic,
                   cuba_tpu_torch.BAConfig(dtype=torch.float32, solver=solver, device="cpu"))
    assert ba._engine.path == "v1" and ba._engine.solver == solver
    n = min(len(got), len(want))
    assert n >= 4
    np.testing.assert_allclose(got[:n], want[:n], rtol=5e-3)
    assert got[n - 1] < got[0]


@pytest.mark.parametrize("solver", ["band_cr", "dense_cholesky"])
def test_fp64_v1_trajectory_matches_xla_path(v2_gate_closed, solver):
    _, want = _run(cuba_tpu, tpu_synthetic,
                   cuba_tpu.BAConfig(dtype=jnp.float64, mxu="off", solver=solver))
    ba, got = _run(cuba_tpu_torch, synthetic,
                   cuba_tpu_torch.BAConfig(dtype=torch.float64, solver=solver, device="cpu"))
    assert ba._engine.path == "v1"
    assert len(got) == len(want) >= 4
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# the route: v2, v1 or the AoS path
# ---------------------------------------------------------------------------


def _arrays(qs, ts, Xws, mp, ml, rng, fixed_p=(0,), fixed_l=()):
    num_p, num_l = len(qs), len(Xws)
    fp = np.zeros(num_p, bool)
    fp[list(fixed_p)] = True
    fl = np.zeros(num_l, bool)
    fl[list(fixed_l)] = True
    mp = np.asarray(mp, np.int32)
    ml = np.asarray(ml, np.int32)
    e = np.zeros((0,), np.int32)
    return (qs, ts, np.tile(np.array([500.0, 500, 320, 240, 0.1]), (num_p, 1)), Xws, fp, fl,
            mp, ml, rng.normal(size=(len(mp), 2)) * 10 + np.array([320.0, 240]),
            np.ones(len(mp)), e, e, np.zeros((0, 3)), np.zeros(0))


def _graph(kind):
    """Small structures of the kinds the route must agree on: scattered
    covisibility (an unordered photo collection), a wide band (40
    observations per landmark), odometry with loop chords (the chords of
    tests/test_band_lr.py), pose-only and landmark-only."""
    rng = np.random.default_rng(11)
    num_p, num_l = 200, 1200
    qs = np.tile(np.array([0.0, 0, 0, 1]), (num_p, 1))
    ts = np.cumsum(rng.normal(0.1, 0.02, size=(num_p, 3)), axis=0)
    Xws = rng.normal(size=(num_l, 3)) * 3 + np.array([0, 0, 6.0])
    mp, ml = [], []
    if kind == "scattered":
        for lm in range(num_l):
            mp += list(rng.choice(num_p, size=4, replace=False))
            ml += [lm] * 4
        return _arrays(qs, ts, Xws, mp, ml, rng)
    width = 40 if kind == "wide" else 3
    for lm in range(num_l):
        base = (lm * num_p) // num_l
        for kk in range(width):
            mp.append(min(base + kk, num_p - 1))
            ml.append(lm)
    if kind.startswith("chords"):
        C = int(kind[-1])
        for c in range(C):
            src = (2 * c + 1) * num_p // (2 * C + 1)
            for frac in (3, 5):
                mp.append((src + frac * num_p // 7) % num_p)
                ml.append((src * num_l) // num_p)
    fixed_l = range(num_l) if kind == "pose_only" else ()
    fixed_p = range(num_p) if kind == "landmark_only" else (0,)
    return _arrays(qs, ts, Xws, mp, ml, rng, fixed_p, fixed_l)


@pytest.mark.parametrize("gate", ["open", "closed"])
@pytest.mark.parametrize("kind", ["scattered", "wide", "chords2", "chords3", "pose_only",
                                  "landmark_only"])
def test_route_matches_cuba_tpu(kind, gate, monkeypatch):
    """The port's rule: the rows front end for every structure with poses,
    landmarks and Hpl slots whose Schur chunk plan holds, v2 where its
    fullest band fits ``_WG_MAX``, else v1; the AoS path elsewhere.  It is
    cuba_tpu's route wherever the TPU's window plans hold.  The scattered
    and wide graphs, whose bands are over ``_WG_MAX`` and which only those
    plans sent to cuba_tpu's XLA path, take v1 with the gate open or
    closed.  There fp64 optimize(10) is held to cuba_tpu's trajectory a
    step at a fixed limit: 1e-6 on the wide graph (the bar of
    tests/test_parity.py; read: 7.7e-10 at most), 2e-5 on the scattered
    graph, whose scale is free, so roundoff grows on its last steps (read:
    4.6e-6, 9.1e-6, 1.15e-5 on steps 8-10, under 4e-8 before; the port's
    AoS path lands as far).  It is also held within 1e-6 a step of the
    port's own AoS path, the route these graphs took before.  The gate
    changes neither side's route there, so the open gate's run checks the
    trajectories."""
    if gate == "closed":
        monkeypatch.setattr(mxu, "_WG_MAX", 0)
        monkeypatch.setattr(rows, "_WG_MAX", 0)
    args = _graph(kind)
    ref_s = tpu_structure.build_structure_from_arrays(*args)
    port_s = structure_from_numpy(ref_s)
    cfg = cuba_tpu_torch.BAConfig(dtype=torch.float64, device="cpu")
    eng = engine.BlockSolverEngine(port_s, ((1, MONO_DELTA), (1, MONO_DELTA)), cfg)
    ref = tpu_engine.BlockSolverEngine(ref_s, ((1, MONO_DELTA), (1, MONO_DELTA)),
                                       cuba_tpu.BAConfig(dtype=jnp.float64, mxu="off"))
    assert (eng.solver, eng.band_m, eng.pad_blocks) == (ref.solver, ref.band_m, ref.pad_blocks)
    plans, _ = mxu.plan_mxu(ref_s, ref.pad_blocks, need_dense=ref.solver != "pcg",
                            wire_pack=False)
    tpu_path = "aos" if not plans.ok else ("v2" if plans.v2 else "v1")
    if kind in ("scattered", "wide"):
        assert tpu_path == "aos" and eng.path == "v1" and eng.solver != "pcg"
        if gate == "open":
            got = np.asarray(eng.optimize(None, 10).chis)
            r = ref.optimize(None, 10)
            want = np.asarray(r.chis)[:int(r.niters)]
            monkeypatch.setattr(rows, "plan_row_tables",
                                lambda s, pad_blocks=0, lr=None: (None, None))
            aos = engine.BlockSolverEngine(port_s, ((1, MONO_DELTA), (1, MONO_DELTA)), cfg)
            assert aos.path == "aos"
            aos = np.asarray(aos.optimize(None, 10).chis)
            assert len(got) == len(want) == len(aos) >= 4 and got[-1] < got[0]
            np.testing.assert_allclose(got, want, rtol={"wide": 1e-6, "scattered": 2e-5}[kind])
            np.testing.assert_allclose(got, aos, rtol=1e-6)
    else:
        assert eng.path == tpu_path
    if tpu_path == "v2":
        assert eng.plan.lr_nob == plans.lr_nob and eng.plan.lr_k == plans.lr_k
    if kind in ("pose_only", "landmark_only"):
        assert eng.path == "aos"
    if kind == "chords2":
        assert eng.solver == "dense_cholesky" and (eng.lr is None)
        assert engine.resolve_solver(port_s, cfg)[3] is not None
