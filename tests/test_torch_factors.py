"""The Schur factors of ``rows.prepare_factors``: the landmarks' damped
3x3 inverses (``hll_inverse``) and each slot's W = Hpl Hll^-1 and W bl
(``slot_factors``).

On the card they are ``csrc/factors.cu``'s two kernels; on the CPU
``prepare_factors`` must return what the port returned before they
existed, bit for bit: the damped fp64 inverse and the two einsums,
restated below as they were.  The CPU cases also hold the wrappers'
refusals, the work counts the chip smoke test reads and the dispatch (a
solve launches each kernel once an attempt).  The ``gpu`` cases hold the
kernels to their plain versions on the card; this file imports no JAX, so
they run without the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_factors.py -q
"""

import types

import numpy as np
import pytest
import torch

from cuba_tpu_torch import BAConfig, EdgeType, RobustKernelType
from cuba_tpu_torch.io import synthetic
from cuba_tpu_torch.ops import cudalib, factors
from cuba_tpu_torch.solver import comm, rows
from cuba_tpu_torch.tools import graphs, roofline


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[torch.float32, torch.float64], ids=["fp32", "fp64"])
def engine(request):
    """A small band graph's engine on the CPU (mono and stereo edges)."""
    torch.set_num_threads(1)
    prob = synthetic.generate(num_poses=40, num_landmarks=600, stereo_fraction=0.25, seed=4)
    ba = graphs.make_graph(prob, BAConfig(dtype=request.param, device="cpu"))
    ba.initialize()
    return ba._engine


def _attempt(engine):
    """(HppT, HllT, HplT, lam) of the engine's first damped attempt."""
    HppT, HllT, HplT = engine._build(*engine._residuals_and_chi(engine.state)[:2])
    return HppT, HllT, HplT, engine.config.tau * rows.max_diagonal_T(HppT, HllT)


def _old_prepare_factors(HppT, HllT, HplT, lam, num_p, rc):
    """``prepare_factors`` as the port computed it before the kernels."""
    hll_d = HllT[:9].clone()
    hll_d[0::4] += lam
    iv9 = rows._sym3x3_inv_rows(hll_d.double()).to(hll_d.dtype)
    src12 = torch.cat([iv9, HllT[9:12]])
    g12 = rows.segmm.gather(src12, rc.hpl_col)
    H = g12.shape[1]
    W = torch.einsum("ike,kme->ime", HplT.view(6, 3, H), g12[:9].view(3, 3, H))
    wbl = torch.einsum("ime,me->ie", W, g12[9:12]).contiguous()
    bsc_sub = rows.segmm.segsum(wbl, rc.hpl_row, num_p, rc.csr_hpl_row)
    return iv9, W.reshape(18, H), HppT[36:42] - comm.all_reduce_sum(bsc_sub, None), g12


def test_prepare_factors_on_cpu_is_the_old_computation(engine):
    HppT, HllT, HplT, lam = _attempt(engine)
    cudalib.reset_launches()
    got = rows.prepare_factors(HppT, HllT, HplT, lam, engine.num_p, engine.rc)
    want = _old_prepare_factors(HppT, HllT, HplT, lam, engine.num_p, engine.rc)
    for name, a, b in zip(("iv9", "W", "bscT", "g12"), got, want):
        assert a.dtype == engine.dtype and torch.equal(a, b), name
    assert got[0].is_contiguous() and got[1].shape == (18, engine.plan.hpl_pad)
    # on the CPU nothing launches
    assert not any(cudalib.LAUNCHES.values()) and not any(cudalib.LAUNCHES_F64.values())


def test_factor_plain_versions(engine):
    """[Hll^-1; bl]: Hll^-1 symmetric and the inverse of Hll damped in the
    working dtype, bl copied; W and W bl the products, 0 on the padding
    slots; the scale bounds every entry."""
    HppT, HllT, HplT, lam = _attempt(engine)
    src12 = rows.hll_inverse_rows(HllT, lam)
    assert src12.shape == (12, engine.num_l) and torch.equal(src12[9:], HllT[9:])
    inv = src12[:9].double().T.reshape(-1, 3, 3)
    assert torch.equal(inv, inv.transpose(1, 2))
    hll_d = HllT[:9].clone()
    hll_d[0::4] += lam
    exact = torch.linalg.inv(hll_d.double().T.reshape(-1, 3, 3))
    scale = exact.abs().amax(dim=(1, 2), keepdim=True)
    assert bool(((inv - exact).abs() <= 1e-6 * scale).all())
    g12 = rows.prepare_factors(HppT, HllT, HplT, lam, engine.num_p, engine.rc)[3]
    W, wbl = rows.slot_factors_rows(HplT, g12)
    H = HplT.shape[1]
    want = HplT.double().T.reshape(H, 6, 3) @ g12[:9].double().T.reshape(H, 3, 3)
    scale_W, scale_wbl = rows.slot_factors_scale(HplT, g12)
    rtol = 1e-5 if engine.dtype == torch.float32 else 1e-12
    assert bool(((W.double() - want.reshape(H, 18).T).abs() <= rtol * scale_W).all())
    pad = (HplT == 0).all(0)
    assert bool(pad.any()) and bool((W[:, pad] == 0).all()) and bool((wbl[:, pad] == 0).all())
    for v, s in zip((W, wbl), (scale_W, scale_wbl)):
        assert bool((v.abs() <= s * (1 + 1e-5)).all())


def _cpu_pair(dtype=torch.float32, L=10, H=16):
    HllT = torch.ones((12, L), dtype=dtype)
    return (HllT, torch.tensor(1.0, dtype=dtype), torch.ones((18, H), dtype=dtype),
            torch.ones((12, H), dtype=dtype))


def test_factor_wrappers_refuse():
    HllT, lam, HplT, g12 = _cpu_pair()
    with pytest.raises(ValueError, match="on cpu"):
        factors.hll_inverse(HllT, lam)
    with pytest.raises(ValueError, match="on cpu"):
        factors.slot_factors(HplT, g12)
    with pytest.raises(TypeError):
        factors.hll_inverse(HllT, lam.double())
    with pytest.raises(TypeError):
        factors.slot_factors(HplT, g12.double())
    with pytest.raises(TypeError):
        factors.slot_factors(HplT.half(), g12.half())
    with pytest.raises(ValueError, match="contiguous"):
        factors.hll_inverse(torch.ones((10, 12)).T, lam)
    with pytest.raises(ValueError, match="contiguous"):
        factors.slot_factors(HplT, torch.ones((16, 12)).T)
    with pytest.raises(ValueError, match="12, L"):
        factors.hll_inverse(HllT[:9].contiguous(), lam)
    with pytest.raises(ValueError):
        factors.hll_inverse(HllT, lam.reshape(1))
    with pytest.raises(ValueError, match="18, H"):
        factors.slot_factors(HplT, g12[:, :15].contiguous())
    with pytest.raises(ValueError, match="18, H"):
        factors.slot_factors(HplT[:17].contiguous(), g12)


@pytest.mark.parametrize("size, inv_bytes, slot_bytes", [(4, 84, 216), (8, 168, 432)])
def test_factor_work(size, inv_bytes, slot_bytes):
    """A landmark reads its Hll's 6 distinct entries and bl and writes 12
    values; a slot reads 30 and writes 24."""
    assert roofline.hll_inverse_work(1000, size) == (1000 * inv_bytes, 1000 * 45)
    assert roofline.slot_factors_work(1000, size) == (1000 * slot_bytes, 1000 * 120)


def test_factor_sites(engine):
    sites = roofline.factor_sites(engine)
    assert sorted(sites) == ["hll_inverse", "slot_factors"]
    size = engine.dtype.itemsize
    assert sites["hll_inverse"].work() == roofline.hll_inverse_work(engine.num_l, size)
    assert sites["slot_factors"].work() == roofline.slot_factors_work(engine.plan.hpl_pad, size)
    assert torch.equal(sites["hll_inverse"].call(rows.hll_inverse_rows),
                       sites["hll_inverse"].call(rows.hll_inverse_plain))
    for a, b in zip(sites["slot_factors"].call(rows.slot_factors_rows),
                    sites["slot_factors"].call(rows.slot_factors_plain)):
        assert torch.equal(a, b)


def test_a_solve_routes_through_both_wrappers(monkeypatch):
    """With the dispatch answering "kernel" (a stand-in for the card: the
    wrappers replaced by counting twins of the plain versions), every
    trial solve calls each wrapper once, inside ``rows.prepare_factors``,
    and the trajectory is the plain one's."""
    prob = synthetic.generate(num_poses=40, num_landmarks=600, stereo_fraction=0.25, seed=4)

    def run():
        ba = graphs.make_graph(prob, BAConfig(device="cpu"))
        ba.initialize()
        ba.optimize(4)
        return ba, [s.chi2 for s in ba.batch_statistics()]

    _ba, want = run()

    def counted(name, plain):
        def twin(*args):
            cudalib.count(name, args[0].dtype)
            return plain(*args)
        return twin

    monkeypatch.setattr(rows, "cudalib", types.SimpleNamespace(use_kernel=lambda *t: True))
    monkeypatch.setattr(factors, "hll_inverse", counted("hll_inverse", rows.hll_inverse_plain))
    monkeypatch.setattr(factors, "slot_factors",
                        counted("slot_factors", rows.slot_factors_plain))
    cudalib.reset_launches()
    ba, got = run()
    attempts = ba.last_result.nattempts
    assert attempts > 0
    assert cudalib.LAUNCHES["hll_inverse"] == cudalib.LAUNCHES["slot_factors"] == attempts
    assert got == want


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _hll_table(rng, L, dtype, device):
    """HllT [12, L] of L landmarks: J^T J of random 4x3 Jacobians, scaled
    over six decades, with landmark 0 near-singular (v v^T + 1e-2 I with
    |v| ~ 173, so its fp32 determinant cancels) and landmark 1 zero (a
    landmark the damping alone holds)."""
    J = rng.standard_normal((L, 4, 3)) * 10.0 ** rng.uniform(-3, 3, (L, 1, 1))
    H = J.transpose(0, 2, 1) @ J
    v = np.full(3, 100.0)
    H[0] = np.outer(v, v) + 1e-2 * np.eye(3)
    H[1] = 0
    bl = rng.standard_normal((L, 3))
    t = np.concatenate([H.reshape(L, 9), bl], axis=1).T
    return torch.from_numpy(np.ascontiguousarray(t)).to(device, dtype)


def _ulp(x):
    a = x.abs()
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


@pytest.mark.gpu
@pytest.mark.parametrize("L", [70001, 0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_hll_inverse_kernel_matches_plain(cuda, dtype, L):
    """``hll_inverse`` against its plain version on the card at L = 70,001
    (no block size divides it) and 0: every entry within one ulp (the same
    fp64 operations, each rounded once), bl copied bit for bit, Hll^-1
    symmetric; the near-singular landmark's inverse is the fp64 one, where
    the same formula in fp32 is far off; one launch a call (none at L = 0),
    an fp64 one in fp64; a second launch gives the same bits."""
    rng = np.random.default_rng(L + 7)
    HllT = _hll_table(rng, L, dtype, cuda) if L else torch.zeros((12, 0), dtype=dtype,
                                                                 device=cuda)
    lam = torch.tensor(1e-4, dtype=dtype, device=cuda)
    before, before64 = cudalib.LAUNCHES["hll_inverse"], cudalib.LAUNCHES_F64["hll_inverse"]
    got = rows.hll_inverse_rows(HllT, lam)
    torch.cuda.synchronize()
    assert cudalib.LAUNCHES["hll_inverse"] == before + (L > 0)
    assert cudalib.LAUNCHES_F64["hll_inverse"] == before64 + (L > 0 and dtype == torch.float64)
    with cudalib.use_plain():
        want = rows.hll_inverse_plain(HllT, lam)
    assert got.shape == want.shape == (12, L) and got.dtype == dtype and got.is_contiguous()
    if not L:
        return
    assert bool(((got - want).abs() <= _ulp(want)).all()), float((got - want).abs().max())
    assert torch.equal(got[9:], HllT[9:])
    inv = got[:9].T.reshape(L, 3, 3)
    assert torch.equal(inv, inv.transpose(1, 2))
    assert torch.equal(got, rows.hll_inverse_rows(HllT, lam))
    # landmark 0 (condition ~3e6): the closed form in fp64 is within ~1e-4 of
    # the inverse of the damped matrix as rounded to dtype; in fp32 it is lost
    h0 = HllT[:9, :1].clone()
    h0[0::4] += lam
    exact = torch.linalg.inv(h0.double().cpu().reshape(3, 3))
    top = float(exact.abs().max())
    assert float((got[:9, 0].double().cpu().reshape(3, 3) - exact).abs().max()) <= 1e-3 * top
    if dtype == torch.float32:
        in_fp32 = rows._sym3x3_inv_rows(h0.cpu()).reshape(3, 3).double()
        assert not float((in_fp32 - exact).abs().max()) <= 0.1 * top


@pytest.mark.gpu
@pytest.mark.parametrize("H", [70001, 0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_slot_factors_kernel_matches_plain(cuda, dtype, H):
    """``slot_factors`` against its plain version (the einsum pair) on the
    card at H = 70,001 and 0: each W and W bl entry within 1e-5 (fp32) or
    1e-12 (fp64) of its sum of |products| (``rows.slot_factors_scale``:
    sums of three products in another order); a tenth of the slots
    padding (Hpl 0, gathered zeros) exactly 0; one launch a call (none at
    H = 0), an fp64 one in fp64; a second launch gives the same bits."""
    rng = np.random.default_rng(H + 11)
    valid = rng.random(H) > 0.1
    hpl = rng.standard_normal((18, H)) * 10.0 ** rng.uniform(-3, 3, H)
    g = rng.standard_normal((12, H)) * 10.0 ** rng.uniform(-3, 3, H)
    hpl[:, ~valid] = 0
    g[:, ~valid] = 0
    HplT, g12 = (torch.from_numpy(np.ascontiguousarray(a)).to(cuda, dtype) for a in (hpl, g))
    before, before64 = cudalib.LAUNCHES["slot_factors"], cudalib.LAUNCHES_F64["slot_factors"]
    W, wbl = rows.slot_factors_rows(HplT, g12)
    torch.cuda.synchronize()
    assert cudalib.LAUNCHES["slot_factors"] == before + (H > 0)
    assert cudalib.LAUNCHES_F64["slot_factors"] == before64 + (H > 0 and dtype == torch.float64)
    with cudalib.use_plain():
        want = rows.slot_factors_rows(HplT, g12)
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    for got, w, scale, d in zip((W, wbl), want, rows.slot_factors_scale(HplT, g12), (18, 6)):
        assert got.shape == w.shape == (d, H) and got.dtype == dtype and got.is_contiguous()
        assert bool(((got - w).abs() <= rtol * scale).all())
        assert bool((got[:, torch.from_numpy(~valid).to(cuda)] == 0).all())
    again = rows.slot_factors_rows(HplT, g12)
    assert torch.equal(W, again[0]) and torch.equal(wbl, again[1])


@pytest.mark.gpu
def test_factor_wrappers_refuse_on_the_card(cuda):
    HllT, lam, HplT, g12 = (t.to(cuda) for t in _cpu_pair())
    with pytest.raises(ValueError, match="on cpu"):
        factors.hll_inverse(HllT, lam.cpu())
    with pytest.raises(ValueError, match="on cpu"):
        factors.slot_factors(HplT, g12.cpu())
    with pytest.raises(TypeError):
        factors.hll_inverse(HllT.half(), lam.half())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_solve_on_the_card_launches_each_once_an_attempt(cuda, dtype):
    """``optimize`` on the card: ``hll_inverse`` and ``slot_factors`` each
    launch once a trial solve, and the chi² trajectory agrees with the
    plain versions' run on the card."""
    prob = synthetic.generate(num_poses=40, num_landmarks=600, stereo_fraction=0.25, seed=4)

    def run():
        ba = synthetic.build_graph(prob, BAConfig(dtype=dtype, device="cuda"))
        ba.set_robust_kernels(RobustKernelType.HUBER, np.sqrt(5.991), EdgeType.MONOCULAR)
        ba.set_robust_kernels(RobustKernelType.HUBER, np.sqrt(7.815), EdgeType.STEREO)
        ba.initialize()
        ba.optimize(6)
        return ba, np.array([s.chi2 for s in ba.batch_statistics()])

    cudalib.reset_launches()
    ba, got = run()
    attempts = ba.last_result.nattempts
    assert cudalib.LAUNCHES["hll_inverse"] == cudalib.LAUNCHES["slot_factors"] == attempts
    assert cudalib.LAUNCHES_F64["slot_factors"] == (attempts if dtype == torch.float64 else 0)
    with cudalib.use_plain():
        _ba, want = run()
    n = min(len(got), len(want))
    np.testing.assert_allclose(got[:n], want[:n], rtol=5e-3 if dtype == torch.float32 else 1e-8)
