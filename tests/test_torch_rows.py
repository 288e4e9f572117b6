"""cuba_tpu_torch.solver.rows against cuba_tpu.solver.mxu, module by module.

cuba_tpu runs its fp32 rows path with the Pallas kernels in interpret mode
(``BAConfig(mxu="interpret", solver="pcg")``); the port runs its plain
versions on the CPU, on the same compiled structure.  The residual pass and
the assembly each take their own inputs (chi to 1e-5, the system to the
1e-3/2e-3 bar of tests/test_mxu_path.py); the Schur factors, the matrix-free
matvec and the back-substitution take the same system values on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuba_tpu.config import BAConfig as TpuConfig
from cuba_tpu.io import synthetic
from cuba_tpu.ops import robust
from cuba_tpu.solver import mxu
from cuba_tpu.solver.engine import BlockSolverEngine as TpuEngine
from cuba_tpu.solver.structure import build_structure_from_arrays
from cuba_tpu_torch.config import BAConfig
from cuba_tpu_torch.interop import state_from_numpy, structure_from_numpy
from cuba_tpu_torch.solver import rows
from cuba_tpu_torch.solver.engine import BlockSolverEngine

torch.set_num_threads(1)

KERNELS = ((robust.HUBER, float(np.sqrt(5.991))), (robust.HUBER, float(np.sqrt(7.815))))


@pytest.fixture(scope="module")
def engines():
    prob = synthetic.generate(num_poses=10, num_landmarks=90, seed=5)
    fp = np.zeros(10, bool)
    fp[prob.fixed_poses] = True
    s = build_structure_from_arrays(
        prob.qs, prob.ts, np.tile(prob.cam, (10, 1)), prob.Xws, fp, np.zeros(90, bool),
        prob.mono_p, prob.mono_l, prob.mono_z, prob.mono_w,
        prob.stereo_p, prob.stereo_l, prob.stereo_z, prob.stereo_w,
    )
    tpu = TpuEngine(s, KERNELS, TpuConfig(dtype=jnp.float32, mxu="interpret", solver="pcg"))
    assert tpu.use_rows
    port = BlockSolverEngine(structure_from_numpy(s), KERNELS,
                             BAConfig(dtype=torch.float32, solver="pcg"))
    rr = tpu._residuals_and_chi(tpu.state, tpu.consts)
    sys_tpu = tpu._build(tpu.state, tpu.consts, *rr[:4])
    return tpu, port, rr, sys_tpu


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol, atol_frac):
    want = np.asarray(want, np.float64)
    got = got.double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * max(float(np.abs(want).max()), 1e-30))


def test_edge_rows_matches(engines):
    tpu, port, rr, _ = engines
    st = tpu.state  # cuba_tpu's own device state, carried across as numpy
    pm, ps, chi = port._residuals_and_chi(state_from_numpy(
        np.asarray(st.qs), np.asarray(st.ts), np.asarray(st.Xws), "cpu", torch.float32))
    np.testing.assert_allclose(float(chi), float(rr[4]), rtol=1e-5)
    for got, want in ((pm, rr[0]), (ps, rr[1])):
        g12, err, Xc, inv_z = got
        np.testing.assert_array_equal(g12.numpy(), np.asarray(want[0]))  # exact gathers
        _close(err, want[1], 1e-4, 1e-5)
        _close(Xc, want[2], 1e-5, 1e-6)


def test_build_system_rows_matches(engines):
    _tpu, port, _rr, sys_tpu = engines
    pm, ps, _ = port._residuals_and_chi(port.state)
    for got, want in zip(port._build(pm, ps), sys_tpu):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=2e-3)


def test_prepare_factors_matches(engines):
    tpu, port, _rr, (HppT, HllT, HplT) = engines
    lam = 1.0
    want = mxu.prepare_factors_mxu(HppT, HllT, HplT, jnp.float32(lam), tpu.num_p, tpu.num_l,
                                   tpu.mxu_plans, tpu.consts.mxu, interpret=True)
    got = rows.prepare_factors(_t(HppT), _t(HllT), _t(HplT), torch.tensor(lam),
                               port.num_p, port.num_l, port.plan, port.rc)
    for name, g, w in zip(("iv9", "W", "bscT", "g12"), got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        _close(g, w, 1e-4, 1e-5)


def test_schur_matvec_matches(engines):
    tpu, port, _rr, (HppT, HllT, HplT) = engines
    lam = jnp.float32(0.5)
    _iv9, W, _b, _g = mxu.prepare_factors_mxu(HppT, HllT, HplT, lam, tpu.num_p, tpu.num_l,
                                              tpu.mxu_plans, tpu.consts.mxu, interpret=True)
    x = np.random.default_rng(0).normal(size=(6, tpu.num_p)).astype(np.float32)
    want = mxu.schur_matvec_rows(HppT, HplT, W, lam, jnp.asarray(x), tpu.num_p, tpu.num_l,
                                 tpu.mxu_plans, tpu.consts.mxu, interpret=True)
    got = rows.schur_matvec_rows(_t(HppT), _t(HplT), _t(W), torch.tensor(0.5),
                                 torch.from_numpy(x), port.num_p, port.num_l,
                                 port.plan, port.rc)
    _close(got, want, 1e-4, 1e-5)


def test_back_substitute_matches(engines):
    tpu, port, _rr, (HppT, HllT, HplT) = engines
    lam = jnp.float32(1.0)
    iv9, _W, _b, g12 = mxu.prepare_factors_mxu(HppT, HllT, HplT, lam, tpu.num_p, tpu.num_l,
                                               tpu.mxu_plans, tpu.consts.mxu, interpret=True)
    xp = np.random.default_rng(1).normal(size=(tpu.num_p, 6)).astype(np.float32) * 1e-2
    want = mxu.back_substitute_mxu(iv9, HllT, HplT, g12, jnp.asarray(xp), tpu.num_l,
                                   tpu.mxu_plans, tpu.consts.mxu, interpret=True)
    got = rows.back_substitute(_t(iv9), _t(HllT), _t(HplT), _t(g12), torch.from_numpy(xp),
                               port.num_l, port.plan, port.rc)
    assert tuple(got.shape) == (tpu.num_l, 3)
    _close(got, want, 1e-4, 1e-5)
