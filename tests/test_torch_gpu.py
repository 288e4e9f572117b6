"""The CUDA kernels of cuba_tpu_torch on the card (marker ``gpu``).

These tests need an NVIDIA GPU with nvcc and skip elsewhere.  The card's
machine has no JAX, so this file imports none and runs without the repo's
conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from cuba_tpu_torch import BAConfig, EdgeType, RobustKernelType
from cuba_tpu_torch.io import synthetic
from cuba_tpu_torch.ops import robust, segmm, walks
from cuba_tpu_torch.solver import dense_cholesky, edgerows, rows, structure, trisolve

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ids(rng, n, num):
    ids = rng.integers(0, num, n)
    u = rng.random(n)
    return np.where(u < 0.1, -1, np.where(u > 0.95, num + 3, ids)).astype(np.int32)


@pytest.mark.parametrize("D", [1, 3, 12])
def test_gather_kernel_matches_plain(cuda, D):
    rng = np.random.default_rng(D)
    src = torch.from_numpy(rng.standard_normal((D, 5000)).astype(np.float32)).to(cuda)
    ids = torch.from_numpy(_ids(rng, 70001, 5000)).to(cuda)  # N odd: no vector width divides it
    before = segmm.LAUNCHES["gather"]
    got = segmm.gather(src, ids)
    want = segmm.gather_plain(src, ids)
    torch.cuda.synchronize()
    assert segmm.LAUNCHES["gather"] == before + 1
    assert torch.equal(got, want)


def _segment_ids(rng, regime):
    """(ids, num_out) of one segment-length regime, with -1 and past-the-end
    ids mixed in: every segment empty, 99 of 100 empty and the others of
    ~20 entries (the kernel then walks a list of those), every one of
    length 1, mean 12, mean 400, or one segment of 100k entries between two
    empty ones."""
    if regime == "empty":
        return np.where(rng.random(5000) < 0.5, -1, 3000 + 7).astype(np.int32), 3000
    if regime == "sparse":
        return _ids(rng, 8000, 40_000) // 100 * 100, 40_000
    if regime == "length1":
        ids = np.concatenate([np.arange(4000), np.full(300, -1), np.full(200, 4009)])
        return rng.permutation(ids).astype(np.int32), 4000
    if regime == "one100k":
        ids = np.concatenate([np.ones(100_000), np.full(50, -1), np.full(50, 3)])
        return rng.permutation(ids).astype(np.int32), 3
    num_out = {"mean12": 2000, "mean400": 100}[regime]
    return _ids(rng, num_out * int(regime[4:]), num_out), num_out


@pytest.mark.parametrize("D", [1, 3, 9, 18, 36, 42])
@pytest.mark.parametrize("regime", ["empty", "sparse", "length1", "mean12", "mean400",
                                    "one100k"])
def test_segsum_kernel_matches_plain(cuda, regime, D):
    rng = np.random.default_rng(1)
    ids_np, num_out = _segment_ids(rng, regime)
    vals_np = rng.standard_normal((D, ids_np.size)).astype(np.float32)
    vals, ids = torch.from_numpy(vals_np).to(cuda), torch.from_numpy(ids_np).to(cuda)
    csr = segmm.segment_csr(ids, num_out, cuda)
    assert (csr.live is not None) == (regime == "sparse")
    before = segmm.LAUNCHES["segsum"]
    got = segmm.segsum(vals, ids, num_out, csr)
    want = segmm.segsum_plain(vals, ids, num_out)
    torch.cuda.synchronize()
    assert segmm.LAUNCHES["segsum"] == before + 1
    bound = segmm.segsum_plain(vals.abs(), ids, num_out)
    assert bool(((got - want).abs() <= 1e-5 * bound).all())
    # the kernel's own summation order, walked in NumPy: the same bits
    walk = walks.segsum_walk(vals_np, csr)
    assert np.array_equal(got.cpu().numpy().view(np.int32), walk.view(np.int32))
    # deterministic: a second launch gives the same bits
    assert torch.equal(got, segmm.segsum(vals, ids, num_out, csr))


def test_kernel_wrappers_reject_bad_input(cuda):
    """float16 has no build and one call takes one float dtype (float32
    and float64 are both valid input)."""
    src = torch.zeros((3, 10), dtype=torch.float16, device=cuda)
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        segmm.gather(src, ids)
    gT = torch.zeros((36, 64), device=cuda)
    dbT = torch.zeros((36, 64), dtype=torch.float64, device=cuda)
    occ = torch.ones(2, dtype=torch.int32, device=cuda)
    iru = torch.full((64,), -1, dtype=torch.int32, device=cuda)
    table = torch.full((64, 128), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        segmm.compact_to_band(gT, iru, iru, dbT, occ, 64, 64, table=table)
    with pytest.raises(ValueError):
        segmm.gather(torch.zeros((10, 3), device=cuda).T, ids)
    with pytest.raises(ValueError):
        segmm.gather(torch.zeros((3, 10)), ids)


def _edge_lanes(rng, E, mdim, dtype, device):
    """(g12, err, Xc, inv_z, omega, valid) of E lanes of one edge type:
    unit quaternions, KITTI cameras (fu == fv, so Hpp's (2, 5) entry
    cancels), camera-frame points 2-30 m ahead, residuals of 0.01-30 pixels
    (so both robust branches are taken), and a tenth of the lanes padding
    as the front end leaves them (gathered zeros, so Xc 0; inv_z, err and
    omega 0)."""
    q = rng.standard_normal((4, E))
    q /= np.linalg.norm(q, axis=0)
    cam = np.array([718.856, 718.856, 607.19, 185.22, 386.14])[:, None].repeat(E, 1)
    valid = rng.random(E) > 0.1
    Xc = np.concatenate([rng.uniform(-20, 20, (2, E)), rng.uniform(2, 30, (1, E))])
    err = rng.standard_normal((mdim, E)) * rng.choice([0.01, 1.0, 30.0], E)
    vals = [np.concatenate([q, rng.standard_normal((3, E)), cam]), err, Xc, 1 / Xc[2],
            rng.uniform(0.5, 2.0, E)]
    for v in vals:
        v[..., ~valid] = 0
    return (*(torch.from_numpy(np.ascontiguousarray(v)).to(device, dtype) for v in vals),
            torch.from_numpy(valid).to(device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["none", "huber", "tukey"])
@pytest.mark.parametrize("mdim", [2, 3])
def test_edge_terms_kernel_matches_plain(cuda, mdim, kind, dtype):
    """``edge_terms`` against ``term_rows``' plain version on the card, at
    E = 70,001 (no block size divides it): every entry within 1e-5 (fp32)
    or 1e-12 (fp64) of its sum of |products| (``term_rows_scale``: both
    form the weighted Jacobians alike and sum in other orders; an entry
    that cancels, as Hpp's (2, 5) does here, is rounding alone); padding
    lanes exactly 0; Hpp and Hll symmetric bit for bit; one launch a call,
    an fp64 one in fp64; float16 and a mixed-device call raise."""
    rng = np.random.default_rng(mdim * 10 + len(kind))
    g12, err, Xc, inv_z, omega, valid = _edge_lanes(rng, 70001, mdim, dtype, cuda)
    kernel = {"none": (robust.NONE, 0.0), "huber": (robust.HUBER, float(np.sqrt(5.991))),
              "tukey": (robust.TUKEY, 3.0)}[kind]
    args = (g12, err, Xc, inv_z, omega, kernel, mdim)
    before, before64 = segmm.LAUNCHES["edge_terms"], segmm.LAUNCHES_F64["edge_terms"]
    got = edgerows.term_rows(*args)
    torch.cuda.synchronize()
    assert segmm.LAUNCHES["edge_terms"] == before + 1
    assert segmm.LAUNCHES_F64["edge_terms"] == before64 + (dtype == torch.float64)
    with segmm.use_plain():
        want = edgerows.term_rows(*args)
    assert segmm.LAUNCHES["edge_terms"] == before + 1
    scale = edgerows.term_rows_scale(*args)
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    # both branches of the robust weight are taken
    w = robust.weight(edgerows.chi_per_edge(err, omega), *kernel)[valid]
    if kind == "huber":
        assert bool((w < 1).any()) and bool((w == 1).any())
    elif kind == "tukey":
        assert bool((w == 0).any()) and bool((w > 0).any())
    for g, w, sc, rows_ in zip(got, want, scale, (42, 12, 18)):
        assert g.shape == (rows_, 70001) and g.dtype == dtype and g.is_contiguous()
        assert bool(((g - w).abs() <= rtol * sc).all()), float(((g - w).abs() / sc).nan_to_num()
                                                              .max())
        assert bool((g[:, ~valid] == 0).all())
    hpp, hll = got[0][:36].view(6, 6, -1), got[1][:9].view(3, 3, -1)
    assert torch.equal(hpp, hpp.transpose(0, 1)) and torch.equal(hll, hll.transpose(0, 1))
    # deterministic: a second launch gives the same bits
    assert all(torch.equal(a, b) for a, b in zip(got, edgerows.term_rows(*args)))
    with pytest.raises(TypeError):
        edgerows.term_rows(*(a.half() if torch.is_tensor(a) else a for a in args))
    with pytest.raises(ValueError):
        edgerows.term_rows(g12, err, Xc, inv_z.cpu(), omega, kernel, mdim)


def test_slice_on_card_matches_plain(cuda):
    prob = synthetic.generate(num_poses=40, num_landmarks=600, seed=4)

    def run():
        ba = synthetic.build_graph(prob, BAConfig(dtype=torch.float32, solver="pcg",
                                                  device="cuda"))
        ba.set_robust_kernels(RobustKernelType.HUBER, np.sqrt(5.991), EdgeType.MONOCULAR)
        ba.set_robust_kernels(RobustKernelType.HUBER, np.sqrt(7.815), EdgeType.STEREO)
        ba.initialize()
        ba.optimize(6)
        return np.array([s.chi2 for s in ba.batch_statistics()])

    segmm.reset_launches()
    got = run()
    assert all(segmm.LAUNCHES[n] > 0 for n in ("gather", "segsum", "edge_terms"))
    with segmm.use_plain():
        want = run()
    n = min(len(got), len(want))
    np.testing.assert_allclose(got[:n], want[:n], rtol=5e-3)
    assert got[-1] < got[0]


@pytest.fixture
def band_plan(cuda):
    """A real band plan (150 poses, 1,400 landmarks) on the card, with
    seeded W / Hpl windows, compact table and damped diagonal."""
    prob = synthetic.generate(num_poses=150, num_landmarks=1400, seed=2)
    fp = np.zeros(150, bool)
    fp[prob.fixed_poses] = True
    s = structure.build_structure_from_arrays(
        prob.qs, prob.ts, np.tile(prob.cam, (150, 1)), prob.Xws, fp, np.zeros(1400, bool),
        prob.mono_p, prob.mono_l, prob.mono_z, prob.mono_w,
        prob.stereo_p, prob.stereo_l, prob.stereo_z, prob.stereo_w)
    PB = rows.pad_blocks_of(s.num_p)
    plan, rc = rows.plan_rows(s, cuda, torch.float32, pad_blocks=PB, dense=True)
    rng = np.random.default_rng(3)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)

    return plan, rc, PB, draw(18, plan.hpl_pad), draw(18, plan.hpl_pad), \
        draw(36, PB // 64 * plan.wg), draw(36, PB)


def test_schur_fused_kernel_matches_plain(band_plan):
    plan, rc, _PB, W, G, _gT, _dbT = band_plan
    args = (plan.schur, rc.sc_sb, rc.sc_li, rc.sc_lj, rc.sc_lk)
    before = segmm.LAUNCHES["schur_fused"]
    got = segmm.schur_fused(W, G, *args, csr=rc.csr_sc)
    want = segmm.schur_fused_plain(W, G, *args)
    bound = segmm.schur_fused_plain(W.abs(), G.abs(), *args)
    torch.cuda.synchronize()
    assert segmm.LAUNCHES["schur_fused"] == before + 1
    assert bool(((got - want).abs() <= 1e-5 * bound).all())
    csr = segmm.schur_lane_csr(plan.schur, W.device)  # built anew: the same order
    assert torch.equal(got, segmm.schur_fused(W, G, *args, csr=csr))
    with pytest.raises(ValueError, match="csr"):
        segmm.schur_fused(W, G, *args)


def test_compact_to_band_kernel_matches_plain(band_plan):
    plan, rc, PB, _W, _G, gT, dbT = band_plan
    args = (gT, rc.iru, rc.icu, dbT, rc.band_occ, PB, plan.wg)
    before = segmm.LAUNCHES["compact_to_band"]
    got = segmm.compact_to_band(*args, table=rc.band_table)
    want = segmm.compact_to_band_plain(*args)
    torch.cuda.synchronize()
    assert segmm.LAUNCHES["compact_to_band"] == before + 1
    assert torch.equal(got, want)  # a placement: bit for bit
    table = torch.from_numpy(segmm.band_table(rc.iru, rc.icu, PB)).to(gT.device)
    assert torch.equal(got, segmm.compact_to_band(*args, table=table))
    with pytest.raises(ValueError, match="table"):
        segmm.compact_to_band(*args)


_KITTI00_LOOP = dict(num_poses=1322, num_landmarks=133383, mean_obs_per_landmark=5.5,
                     stereo_fraction=0.25, seed=0, loop_closure=True)  # chip_smoke.KITTI


@pytest.fixture(scope="module")
def kitti_plan():
    """The kitti00 loop graph's band plan (chunk 1024, kwin 256, 2034
    chunks, PB 1408) on the card, with seeded W / Hpl, compact table and
    damped diagonal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda = torch.device("cuda")
    prob = synthetic.generate(**_KITTI00_LOOP)
    P, L = prob.qs.shape[0], prob.Xws.shape[0]
    fp = np.zeros(P, bool)
    fp[prob.fixed_poses] = True
    s = structure.build_structure_from_arrays(
        prob.qs, prob.ts, np.tile(prob.cam, (P, 1)), prob.Xws, fp, np.zeros(L, bool),
        prob.mono_p, prob.mono_l, prob.mono_z, prob.mono_w,
        prob.stereo_p, prob.stereo_l, prob.stereo_z, prob.stereo_w)
    PB = rows.pad_blocks_of(s.num_p)
    plan, rc = rows.plan_rows(s, cuda, torch.float32, pad_blocks=PB)
    gen = torch.Generator(device=cuda).manual_seed(5)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=cuda)

    return plan, rc, PB, draw(18, plan.hpl_pad), draw(18, plan.hpl_pad), \
        draw(36, PB // 64 * plan.wg), draw(36, PB)


@pytest.fixture(params=["band_plan", "kitti_plan"])
def any_plan(request):
    return request.getfixturevalue(request.param)


def _walk_args(plan, rc):
    return plan.schur, rc.sc_sb.cpu(), rc.sc_li.cpu(), rc.sc_lj.cpu(), rc.csr_sc


def test_schur_fused_kernel_follows_its_walk(any_plan):
    """``walks.schur_fused_walk``'s bits (each output its lane's triplets in
    CSR order, three FMAs a triplet), one launch counted, and the same bits
    on a relaunch."""
    plan, rc, _PB, W, G, _gT, _dbT = any_plan
    sc = plan.schur
    args = (sc, rc.sc_sb, rc.sc_li, rc.sc_lj, rc.sc_lk)
    before = segmm.LAUNCHES["schur_fused"]
    got = segmm.schur_fused(W, G, *args, csr=rc.csr_sc)
    torch.cuda.synchronize()
    assert segmm.LAUNCHES["schur_fused"] == before + 1
    want = walks.schur_fused_walk(W.cpu().numpy(), G.cpu().numpy(), *_walk_args(plan, rc))
    assert np.array_equal(_bits(got), want.view(np.int32))
    assert torch.equal(got, segmm.schur_fused(W, G, *args, csr=rc.csr_sc))


def test_compact_to_band_kernel_follows_its_walk(any_plan):
    """Bit for bit the NumPy walk of its blocks and threads and the plain
    version; the same bits on a relaunch."""
    plan, rc, PB, _W, _G, gT, dbT = any_plan
    args = (gT, rc.iru, rc.icu, dbT, rc.band_occ, PB, plan.wg)
    got = segmm.compact_to_band(*args, table=rc.band_table)
    torch.cuda.synchronize()
    walk = walks.compact_to_band_walk(gT.cpu().numpy(), rc.band_table.cpu().numpy(),
                                      dbT.cpu().numpy(), rc.band_occ.cpu().numpy(), PB)
    assert np.array_equal(_bits(got), walk.view(np.int32))
    assert torch.equal(got, segmm.compact_to_band_plain(*args))
    assert torch.equal(got, segmm.compact_to_band(*args, table=rc.band_table))


@pytest.mark.parametrize("case", ["W 4 bytes off", "G 4 bytes off", "rows of 4k + 1 floats"])
def test_schur_fused_refuses_input_its_copies_cannot_take(band_plan, case):
    """The kernel stages W and G windows with 16-byte copies: a misaligned
    base or a row length that is not a multiple of 4 floats raises."""
    plan, rc, _PB, W, G, _gT, _dbT = band_plan
    H = W.shape[1]
    if case == "rows of 4k + 1 floats":
        W = torch.cat([W, W[:, :1]], 1).contiguous()
        G = torch.cat([G, G[:, :1]], 1).contiguous()
    else:
        off = torch.empty(18 * H + 1, device=W.device)[1:].view(18, H)
        off.copy_(W if case[0] == "W" else G)
        W, G = (off, G) if case[0] == "W" else (W, off)
    with pytest.raises(ValueError, match="aligned"):
        segmm.schur_fused(W, G, plan.schur, rc.sc_sb, rc.sc_li, rc.sc_lj, rc.sc_lk,
                          csr=rc.csr_sc)


def test_build_reports_the_two_formation_kernels(kitti_plan):
    """Registers, spills and resident blocks of the built kernels at the
    kitti00 launch: schur_fused two blocks an SM, compact_to_band at least
    four, neither spilling."""
    for name, launch, least in (
            ("schur_fused", segmm.schur_fused_launch(kitti_plan[0].schur), 2),
            ("compact_to_band", segmm.compact_to_band_launch(kitti_plan[2]), 4)):
        attrs = segmm.kernel_attributes(name, launch)
        print(name, launch, attrs)
        assert attrs["registers"] > 0 and attrs["blocks_per_sm"] >= least, (name, attrs)
        assert attrs["spill_bytes"] == 0, (name, attrs)


def test_band_slice_on_card_matches_plain(cuda):
    prob = synthetic.generate(num_poses=150, num_landmarks=1400, seed=2)

    def run():
        ba = synthetic.build_graph(prob, BAConfig(dtype=torch.float32, solver="band_cr",
                                                  device="cuda"))
        ba.set_robust_kernels(RobustKernelType.HUBER, np.sqrt(5.991), EdgeType.MONOCULAR)
        ba.set_robust_kernels(RobustKernelType.HUBER, np.sqrt(7.815), EdgeType.STEREO)
        ba.initialize()
        ba.optimize(6)
        return np.array([s.chi2 for s in ba.batch_statistics()])

    segmm.reset_launches()
    got = run()
    assert all(segmm.LAUNCHES[n] > 0 for n in ("schur_fused", "compact_to_band", "segsum"))
    with segmm.use_plain():
        want = run()
    n = min(len(got), len(want))
    np.testing.assert_allclose(got[:n], want[:n], rtol=5e-3)
    assert got[-1] < got[0]


def test_compact_to_dense_kernel_follows_its_walk(band_plan):
    """Bit for bit the NumPy walk of its blocks and threads (each output
    float4 written once) and the plain version; the same bits on a
    relaunch."""
    plan, rc, PB, _W, _G, gT, dbT = band_plan
    args = (gT, rc.iru, rc.icu, dbT, rc.occ2, PB, plan.wg)
    got = segmm.compact_to_dense(*args, table=rc.dense_table)
    torch.cuda.synchronize()
    walk, writes = walks.compact_to_dense_walk(gT.cpu().numpy(), rc.dense_table.cpu().numpy(),
                                               dbT.cpu().numpy(), rc.occ2.cpu().numpy(), PB)
    assert np.all(writes == 1)
    assert np.array_equal(_bits(got), walk.view(np.int32))
    assert torch.equal(got, segmm.compact_to_dense(*args, table=rc.dense_table))


def test_compact_to_dense_kernel_matches_plain_at_kitti00(kitti_plan):
    """The kitti00 loop graph's plan (PB 1408, n = 8448: 1408 x 11 blocks),
    its [PB, PB] table built here: one launch, bit for bit the plain
    version, and the build's registers without spills."""
    plan, rc, PB, _W, _G, gT, dbT = kitti_plan
    table = torch.from_numpy(segmm.dense_table(rc.iru, rc.icu, PB)).to(gT.device)
    args = (gT, rc.iru, rc.icu, dbT, rc.occ2, PB, plan.wg)
    before = segmm.LAUNCHES["compact_to_dense"]
    got = segmm.compact_to_dense(*args, table=table)
    torch.cuda.synchronize()
    assert segmm.LAUNCHES["compact_to_dense"] == before + 1
    assert torch.equal(got, segmm.compact_to_dense_plain(*args))
    launch = segmm.compact_to_dense_launch(PB)
    attrs = segmm.kernel_attributes("compact_to_dense", launch)
    print("compact_to_dense", launch, attrs)
    assert attrs["blocks_per_sm"] >= 4 and attrs["spill_bytes"] == 0, attrs


def test_compact_to_dense_kernel_matches_plain(band_plan):
    plan, rc, PB, _W, _G, gT, dbT = band_plan
    args = (gT, rc.iru, rc.icu, dbT, rc.occ2, PB, plan.wg)
    before = segmm.LAUNCHES["compact_to_dense"]
    got = segmm.compact_to_dense(*args, table=rc.dense_table)
    want = segmm.compact_to_dense_plain(*args)
    torch.cuda.synchronize()
    assert segmm.LAUNCHES["compact_to_dense"] == before + 1
    assert got.shape == (6 * PB, 6 * PB)
    assert torch.equal(got, want)  # a placement: bit for bit
    with pytest.raises(ValueError, match="table"):
        segmm.compact_to_dense(*args)


@pytest.fixture
def spd_factor(cuda):
    """A seeded SPD matrix at n = 1536 (six stripes) on the card, its
    Cholesky factor and inverted diagonal blocks, and a right-hand side."""
    n = 1536
    rng = np.random.default_rng(7)
    G = rng.standard_normal((n, n))
    A = torch.from_numpy((G @ G.T / n + np.eye(n)).astype(np.float32)).to(cuda)
    L = torch.linalg.cholesky(A).contiguous()  # torch's factor is column-major
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    with segmm.use_plain():
        invd = trisolve.prepare(L)
    return A, L, invd, b


def test_extract_diag_blocks_kernel_matches_plain(spd_factor):
    _A, L, _invd, _b = spd_factor
    before = segmm.LAUNCHES["extract_diag_blocks"]
    got = trisolve.extract_diag_blocks(L)
    torch.cuda.synchronize()
    assert segmm.LAUNCHES["extract_diag_blocks"] == before + 1
    assert torch.equal(got, trisolve.extract_diag_blocks_plain(L))


@pytest.mark.parametrize("name", ["solve_lower", "solve_upper"])
def test_triangular_sweep_kernel_matches_plain(spd_factor, name):
    _A, L, invd, b = spd_factor
    before = segmm.LAUNCHES[name]
    got = getattr(trisolve, name)(L, invd, b)
    want = getattr(trisolve, name + "_plain")(L, invd, b)
    torch.cuda.synchronize()
    assert segmm.LAUNCHES[name] == before + 1
    # fp32 sums in other orders through six stripes of a well-conditioned L
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(got, getattr(trisolve, name)(L, invd, b))  # deterministic


def _sweep_problem(n, device):
    """A seeded SPD matrix's row-major Cholesky factor at n = 256 K, its
    inverted diagonal blocks and a right-hand side, made on the card."""
    gen = torch.Generator(device=device).manual_seed(n)
    M = torch.randn((n, n), generator=gen, device=device)
    L = torch.linalg.cholesky(M @ M.T / n + torch.eye(n, device=device)).contiguous()
    del M
    with segmm.use_plain():
        invd = trisolve.prepare(L)
    return L, invd, torch.randn(n, generator=gen, device=device)


@pytest.mark.parametrize("n", [512, 1536, 8448])
def test_solve_upper_kernel_matches_plain(cuda, n):
    """K = 2, 6 (kitti07) and 33 (kitti00 built dense): one launch a call,
    within 1e-5 of max |x| of the plain version (fp32 sums in other
    orders), the same bits over 20 calls, each with a workspace of its
    own."""
    _sweep_matches_plain("solve_upper", n, cuda)


@pytest.mark.parametrize("n", [512, 1536, 8448])
def test_solve_lower_kernel_matches_plain(cuda, n):
    """As the backward sweep: one launch a call, within 1e-5 of max |y| of
    the plain version, the same bits over 20 calls."""
    _sweep_matches_plain("solve_lower", n, cuda)


def _sweep_matches_plain(name, n, cuda):
    L, invd, v = _sweep_problem(n, cuda)
    before = segmm.LAUNCHES[name]
    got = getattr(trisolve, name)(L, invd, v)
    want = getattr(trisolve, name + "_plain")(L, invd, v)
    torch.cuda.synchronize()
    assert segmm.LAUNCHES[name] == before + 1
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    for _ in range(20):
        assert torch.equal(got, getattr(trisolve, name)(L, invd, v))
    assert segmm.LAUNCHES[name] == before + 21


@pytest.mark.parametrize("n", [512, 1536])
def test_solve_upper_kernel_follows_its_walk(cuda, n):
    """Bit for bit ``solve_upper_walk`` (the kernel's order, each FMA
    rounded once)."""
    L, invd, y = _sweep_problem(n, cuda)
    got = trisolve.solve_upper(L, invd, y)
    want = walks.solve_upper_walk(L.cpu().numpy(), invd.cpu().numpy(), y.cpu().numpy())
    assert np.array_equal(_bits(got), want.view(np.int32))


@pytest.mark.parametrize("n", [512, 1536, 8448])
def test_solve_lower_kernel_follows_its_walk(cuda, n):
    """Bit for bit ``solve_lower_walk`` (the kernel's order, each FMA
    rounded once), at K = 2, 6 and 33."""
    L, invd, b = _sweep_problem(n, cuda)
    got = trisolve.solve_lower(L, invd, b)
    want = walks.solve_lower_walk(L.cpu().numpy(), invd.cpu().numpy(), b.cpu().numpy())
    assert np.array_equal(_bits(got), want.view(np.int32))


def _kernels_per_call(call):
    """The device kernels of five calls of ``call`` under the profiler,
    call by call.  Calls are split by ``torch.cuda._sleep`` marks; the
    trace can miss a session's first events, so a call counts between two
    marks."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()  # built and loaded outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            torch.cuda._sleep(1)
            call()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    calls, cur = [], None
    for _start, name in spans:
        if "spin_kernel" in name:
            if cur is not None:
                calls.append(cur)
            cur = []
        elif cur is not None:
            cur.append(name)
    assert len(calls) >= 3, spans
    return calls


def test_solve_upper_is_one_kernel_launch(cuda):
    """The device trace of a call: one solve_upper_kernel, and at most one
    more operation (the workspace's zeroing)."""
    L, invd, y = _sweep_problem(1536, cuda)
    for names in _kernels_per_call(lambda: trisolve.solve_upper(L, invd, y)):
        assert sum("solve_upper_kernel" in s for s in names) == 1 and len(names) <= 2, names


def test_solve_lower_is_one_kernel_launch(cuda):
    """The device trace of a call: one solve_lower_kernel, and at most one
    more operation (the workspace's zeroing)."""
    L, invd, b = _sweep_problem(1536, cuda)
    for names in _kernels_per_call(lambda: trisolve.solve_lower(L, invd, b)):
        assert sum("solve_lower_kernel" in s for s in names) == 1 and len(names) <= 2, names


def test_solve_upper_refuses_a_misaligned_L(cuda):
    _refuses_a_misaligned_L(trisolve.solve_upper, cuda)


def test_solve_lower_refuses_a_misaligned_L(cuda):
    _refuses_a_misaligned_L(trisolve.solve_lower, cuda)


def _refuses_a_misaligned_L(sweep, cuda):
    n = 512
    L, invd, v = _sweep_problem(n, cuda)
    Lm = torch.empty(n * n + 1, device=cuda)[1:].view(n, n)  # contiguous, 4 bytes off
    Lm.copy_(L)
    with pytest.raises(ValueError, match="aligned"):
        sweep(Lm, invd, v)


def test_matvec_kernel_matches_plain(spd_factor):
    A, _L, _invd, b = spd_factor
    before = segmm.LAUNCHES["matvec"]
    got = trisolve.matvec(A, b)
    torch.cuda.synchronize()
    assert segmm.LAUNCHES["matvec"] == before + 1
    bound = 1e-5 * (A.abs() @ b.abs())
    assert bool(((got - trisolve.matvec_plain(A, b)).abs() <= bound).all())
    assert torch.equal(got, trisolve.matvec(A, b))  # deterministic


@pytest.mark.parametrize("n", [512, 1536, 8448])
def test_extract_diag_blocks_kernel_is_a_copy(cuda, n):
    """Bit for bit the plain version at the dense path's sizes (K = 2, the
    kitti07 6 and kitti00's 33)."""
    L = torch.from_numpy(np.random.default_rng(n).standard_normal((n, n)).astype(
        np.float32)).to(cuda)
    want = trisolve.extract_diag_blocks_plain(L)
    before = segmm.LAUNCHES["extract_diag_blocks"]
    got = trisolve.extract_diag_blocks(L)
    torch.cuda.synchronize()
    assert segmm.LAUNCHES["extract_diag_blocks"] == before + 1
    assert torch.equal(got, want)


def test_extract_diag_blocks_refuses_a_misaligned_L(cuda):
    n = 512
    L = torch.zeros(n * n + 1, device=cuda)[1:].view(n, n)  # contiguous, 4 bytes off
    assert L.is_contiguous() and L.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        trisolve.extract_diag_blocks(L)


def _matvec_problem(n, device):
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n)).astype(np.float32)
    x = (rng.standard_normal(n) * np.exp(rng.uniform(-3, 3, n))).astype(np.float32)
    return A, x, torch.from_numpy(A).to(device), torch.from_numpy(x).to(device)


def _bits(t):
    return t.cpu().numpy().view(np.int32)


@pytest.mark.parametrize("n", [1, 3, 255, 1536, 8448])
def test_matvec_kernel_follows_its_walk(cuda, n):
    """Within 1e-6 of each row's sum of |A_ij x_j| of ``matvec_walk`` and, the
    walk being the kernel's order, its bits; the same bits on a relaunch."""
    A_np, x_np, A, x = _matvec_problem(n, cuda)
    before = segmm.LAUNCHES["matvec"]
    got = trisolve.matvec(A, x)
    torch.cuda.synchronize()
    assert segmm.LAUNCHES["matvec"] == before + 1
    walk = walks.matvec_walk(A_np, x_np)
    bound = np.abs(A_np).astype(np.float64) @ np.abs(x_np).astype(np.float64)
    assert np.all(np.abs(got.cpu().numpy().astype(np.float64) - walk) <= 1e-6 * bound)
    assert np.array_equal(_bits(got), walk.view(np.int32))
    assert np.array_equal(_bits(got), _bits(trisolve.matvec(A, x)))


@pytest.mark.parametrize("slices", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [1001, 1536])
def test_matvec_kernel_every_launch_follows_its_walk(cuda, n, slices):
    """Every S the probe sweeps, with scalar loads (n = 1001, a partial last
    quad) and float4 loads (1536): the walk's bits."""
    A_np, x_np, A, x = _matvec_problem(n, cuda)
    got = trisolve._matvec_kernel(A, x, slices)
    want = walks.matvec_walk(A_np, x_np, slices)
    assert np.array_equal(_bits(got), want.view(np.int32))


def test_matvec_kernel_misaligned_takes_the_scalar_loads(cuda):
    """A view 4 bytes off takes the scalar loads, in the same order: the
    same bits as the float4 launch."""
    n = 1536
    _A_np, _x_np, A, x = _matvec_problem(n, cuda)
    Am = torch.empty(n * n + 1, device=cuda)[1:].view(n, n)
    Am.copy_(A)
    assert trisolve.matvec_launch(A, x)["float4"] and not trisolve.matvec_launch(Am, x)["float4"]
    assert np.array_equal(_bits(trisolve.matvec(Am, x)), _bits(trisolve.matvec(A, x)))


def test_cholesky_solve_kernels_match_plain(spd_factor):
    A, _L, _invd, b = spd_factor
    x, ok, reads = dense_cholesky.cholesky_solve(A, b, 2, use_kernels=True)
    with segmm.use_plain():
        xp, okp, _ = dense_cholesky.cholesky_solve(A, b, 2, use_kernels=True)
    xs, oks, _ = dense_cholesky.cholesky_solve(A, b, 2, use_kernels=False)
    assert bool(ok) and bool(okp) and bool(oks) and reads == 1
    scale = float(xs.abs().max())
    assert float((x - xp).abs().max()) <= 1e-5 * scale
    assert float((x - xs).abs().max()) <= 1e-5 * scale


def test_dense_slice_on_card_matches_plain(cuda):
    prob = synthetic.generate(num_poses=10, num_landmarks=90, seed=7)

    def run():
        ba = synthetic.build_graph(prob, BAConfig(dtype=torch.float32, device="cuda"))
        ba.set_robust_kernels(RobustKernelType.HUBER, np.sqrt(5.991), EdgeType.MONOCULAR)
        ba.set_robust_kernels(RobustKernelType.HUBER, np.sqrt(7.815), EdgeType.STEREO)
        ba.initialize()
        ba.optimize(6)
        assert ba._engine.solver == "dense_cholesky"
        return np.array([s.chi2 for s in ba.batch_statistics()])

    segmm.reset_launches()
    got = run()
    assert all(segmm.LAUNCHES[n] > 0 for n in (
        "compact_to_dense", "extract_diag_blocks", "solve_lower", "solve_upper", "matvec"))
    with segmm.use_plain():
        want = run()
    n = min(len(got), len(want))
    np.testing.assert_allclose(got[:n], want[:n], rtol=5e-3)
    assert got[-1] < got[0]


def test_band_transpose_kernel_matches_plain(cuda):
    PB = 256
    rng = np.random.default_rng(11)
    m4 = torch.from_numpy(rng.standard_normal((36, PB, PB)).astype(np.float32)).to(cuda)
    occ = torch.from_numpy((rng.random(PB // 64 * PB // 128) < 0.5).astype(np.int32)).to(cuda)
    before = segmm.LAUNCHES["band_transpose"]
    got = segmm.band_transpose(m4, occ, PB)
    torch.cuda.synchronize()
    assert segmm.LAUNCHES["band_transpose"] == before + 1
    assert torch.equal(got, segmm.band_transpose_plain(m4, occ, PB))  # a copy: bit for bit
    full = torch.ones_like(occ)
    assert torch.equal(segmm.band_transpose(m4, full, PB),
                       m4.view(6, 6, PB, PB).permute(2, 0, 3, 1).reshape(6 * PB, 6 * PB))


def _graph_run(prob, config, niters=6, edit=None):
    ba = synthetic.build_graph(prob, config)
    if edit is not None:
        edit(ba)
    ba.set_robust_kernels(RobustKernelType.HUBER, np.sqrt(5.991), EdgeType.MONOCULAR)
    ba.set_robust_kernels(RobustKernelType.HUBER, np.sqrt(7.815), EdgeType.STEREO)
    ba.initialize()
    ba.optimize(niters)
    return ba, np.array([s.chi2 for s in ba.batch_statistics()])


def _against_plain(prob, config, route, kernels, edit=None):
    segmm.reset_launches()
    ba, got = _graph_run(prob, config, edit=edit)
    assert ba._engine.path == route
    assert all(segmm.LAUNCHES[n] > 0 for n in kernels), dict(segmm.LAUNCHES)
    with segmm.use_plain():
        _, want = _graph_run(prob, config, edit=edit)
    n = min(len(got), len(want))
    np.testing.assert_allclose(got[:n], want[:n], rtol=5e-3)
    assert got[-1] < got[0]


def test_v1_slice_on_card_matches_plain(cuda, monkeypatch):
    monkeypatch.setattr(rows, "_WG_MAX", 0)  # close the v2 gate
    _against_plain(synthetic.generate(num_poses=150, num_landmarks=1400, seed=2),
                   BAConfig(dtype=torch.float32, solver="band_cr", device="cuda"), "v1",
                   ("schur_fused", "segsum", "band_transpose"))


def _add_chords(ba):
    """Three landmarks near pose 5 seen again from pose 150: loop-closure
    blocks two CR blocks off the diagonal."""
    from cuba_tpu_torch.models.types import MonoEdge

    near5 = sorted({e.vertexL.id for e in ba.pose_vertex(5).edges})[:3]
    for lm in near5:
        ba.add_monocular_edge(MonoEdge(np.array([600.0, 180.0]), 1.0, ba.pose_vertex(150),
                                       ba.landmark_vertex(lm)))


def test_band_lr_slice_on_card_matches_plain(cuda):
    _against_plain(synthetic.generate(num_poses=200, num_landmarks=1000, seed=4),
                   BAConfig(dtype=torch.float32, solver="band_lr", device="cuda"), "v2",
                   ("schur_fused", "compact_to_band"), edit=_add_chords)


@pytest.mark.parametrize("fix", ["none", "landmarks"])
def test_aos_slice_on_card_matches_plain(cuda, monkeypatch, fix):
    """The AoS path on the card: a planned graph with the planner made to
    find no plan, and a pose-only problem, which the planner sends there."""
    if fix == "none":
        monkeypatch.setattr(rows, "plan_row_tables", lambda s, pad_blocks=0, lr=None: (None, None))

    def edit(ba):
        if fix == "landmarks":
            for j in range(ba.nlandmarks()):
                ba.landmark_vertex(j).fixed = True

    _against_plain(synthetic.generate(num_poses=40, num_landmarks=600, seed=4),
                   BAConfig(dtype=torch.float32, device="cuda"), "aos", ("segsum",),
                   edit=edit)


def _api_graph(config):
    prob = synthetic.generate(num_poses=40, num_landmarks=600, seed=4)
    ba = synthetic.build_graph(prob, config)
    ba.set_robust_kernels(RobustKernelType.HUBER, np.sqrt(5.991), EdgeType.MONOCULAR)
    ba.set_robust_kernels(RobustKernelType.HUBER, np.sqrt(7.815), EdgeType.STEREO)
    return ba


def test_profiled_run_on_card_matches_plain(cuda):
    """optimize(n, profile=True) on the card: the plain loop's trajectory
    to 5e-3 per iteration, every kernel of its path launched, phases 2, 3,
    6 and 7 timed and 4 and 5 at 0."""
    plain = _api_graph(BAConfig(dtype=torch.float32, device="cuda"))
    plain.initialize()
    plain.optimize(6)
    segmm.reset_launches()
    ba = _api_graph(BAConfig(dtype=torch.float32, device="cuda"))
    ba.initialize()
    ba.optimize(6, profile=True)
    assert all(segmm.LAUNCHES[n] > 0 for n in ("gather", "segsum", "schur_fused"))
    got = np.array([s.chi2 for s in ba.batch_statistics()])
    want = np.array([s.chi2 for s in plain.batch_statistics()])
    np.testing.assert_allclose(got, want, rtol=5e-3)
    prof = ba.time_profile()
    assert {k for k, v in prof.items() if v == 0.0} == {"4: Schur Complement",
                                                        "5: Symbolic Decomposition"}
    assert ba.attributed_phases() == set()


def test_event_split_sums_to_the_wall_on_card(cuda):
    ba = _api_graph(BAConfig(dtype=torch.float32, device="cuda"))
    ba.initialize()
    ba.optimize(4)
    marks = ba._pending_attr[0][1]
    assert marks.cuda and all(isinstance(t, torch.cuda.Event) for _, t in marks.marks)
    prof = ba.time_profile()
    phases = ("2: Compute Error", "3: Build System", "4: Schur Complement",
              "6: Numerical Decomposition", "7: Update Solution")
    assert all(prof[k] > 0 for k in phases)
    total = prof["optimize (fused device loop)"]
    assert abs(sum(prof[k] for k in phases) - total) <= 1e-6 * total
    assert ba.attributed_phases() == set(phases)


def test_chi_squared_after_an_edit_on_card(cuda):
    ba = _api_graph(BAConfig(dtype=torch.float32, device="cuda"))
    ba.initialize()
    edges = list(ba._mono_edges) + list(ba._stereo_edges)
    assert ba.chi_squared(edges[1]) == 0.0
    ba.optimize(4)
    want = ba._engine.chi_squares(ba._state)
    ba.remove_edge(edges[0])
    got = np.array([ba.chi_squared(e) for e in edges])
    assert np.all(np.isfinite(got)) and np.all(got >= 0)
    np.testing.assert_array_equal(got, want)


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    ba = _api_graph(BAConfig(dtype=torch.float32, device="cuda"))
    ba.initialize()
    ba.optimize(4)
    path = str(tmp_path / "ckpt.npz")
    ba.save_checkpoint(path)
    fresh = _api_graph(BAConfig(dtype=torch.float32, device="cuda"))
    fresh.load_checkpoint(path)
    assert ([(s.iteration, s.chi2) for s in fresh.batch_statistics()]
            == [(s.iteration, s.chi2) for s in ba.batch_statistics()])
    fresh.initialize()
    for a, b in zip(fresh._engine.state, ba._state):
        assert torch.equal(a, b)
    fresh.optimize(3)
    chis = np.array([s.chi2 for s in fresh.batch_statistics()])
    assert np.all(np.isfinite(chis)) and chis[-1] <= ba.batch_statistics()[-1].chi2


# ---- fp64: the same kernels built for double (entries cuba_<name>_f64)


def _f64_counted(name, call):
    """``call()`` must launch ``name``'s fp64 kernel once (LAUNCHES and
    LAUNCHES_F64 each up by one)."""
    before = (segmm.LAUNCHES[name], segmm.LAUNCHES_F64[name])
    got = call()
    torch.cuda.synchronize()
    assert (segmm.LAUNCHES[name], segmm.LAUNCHES_F64[name]) == (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.float64
    return got


@pytest.mark.parametrize("D", [1, 3, 12])
def test_gather_kernel_matches_plain_fp64(cuda, D):
    rng = np.random.default_rng(D)
    src = torch.from_numpy(rng.standard_normal((D, 5000))).to(cuda)
    ids = torch.from_numpy(_ids(rng, 70001, 5000)).to(cuda)
    got = _f64_counted("gather", lambda: segmm.gather(src, ids))
    assert torch.equal(got, segmm.gather_plain(src, ids))
    assert torch.equal(got, segmm.gather(src, ids))


@pytest.mark.parametrize("D", [3, 42])
@pytest.mark.parametrize("regime", ["empty", "sparse", "length1", "mean12", "mean400",
                                    "one100k"])
def test_segsum_kernel_matches_plain_fp64(cuda, regime, D):
    """Within 1e-13 of each output's sum of |vals| of the plain version,
    bit for bit the fp64 walk of its order, and the same bits twice."""
    rng = np.random.default_rng(1)
    ids_np, num_out = _segment_ids(rng, regime)
    vals_np = rng.standard_normal((D, ids_np.size))
    vals, ids = torch.from_numpy(vals_np).to(cuda), torch.from_numpy(ids_np).to(cuda)
    csr = segmm.segment_csr(ids, num_out, cuda)
    got = _f64_counted("segsum", lambda: segmm.segsum(vals, ids, num_out, csr))
    want = segmm.segsum_plain(vals, ids, num_out)
    bound = segmm.segsum_plain(vals.abs(), ids, num_out)
    assert bool(((got - want).abs() <= 1e-13 * bound).all())
    walk = walks.segsum_walk(vals_np, csr)
    assert np.array_equal(got.cpu().numpy().view(np.int64), walk.view(np.int64))
    assert torch.equal(got, segmm.segsum(vals, ids, num_out, csr))


def _f64(plan_tuple):
    plan, rc, PB, W, G, gT, dbT = plan_tuple
    return plan, rc, PB, W.double(), G.double(), gT.double(), dbT.double()


def test_schur_fused_kernel_matches_plain_fp64(any_plan):
    plan, rc, _PB, W, G, _gT, _dbT = _f64(any_plan)
    args = (plan.schur, rc.sc_sb, rc.sc_li, rc.sc_lj, rc.sc_lk)
    got = _f64_counted("schur_fused", lambda: segmm.schur_fused(W, G, *args, csr=rc.csr_sc))
    want = segmm.schur_fused_plain(W, G, *args)
    bound = segmm.schur_fused_plain(W.abs(), G.abs(), *args)
    assert bool(((got - want).abs() <= 1e-13 * bound).all())
    assert torch.equal(got, segmm.schur_fused(W, G, *args, csr=rc.csr_sc))
    # the fp32 kernel on the same values rounds: the fp64 one does not
    got32 = segmm.schur_fused(W.float(), G.float(), *args, csr=rc.csr_sc)
    assert float((got32.double() - want).abs().max()) > float((got - want).abs().max())


def test_compact_to_band_kernel_matches_plain_fp64(any_plan):
    plan, rc, PB, _W, _G, gT, dbT = _f64(any_plan)
    args = (gT, rc.iru, rc.icu, dbT, rc.band_occ, PB, plan.wg)
    got = _f64_counted("compact_to_band",
                       lambda: segmm.compact_to_band(*args, table=rc.band_table))
    assert torch.equal(got, segmm.compact_to_band_plain(*args))
    assert torch.equal(got, segmm.compact_to_band(*args, table=rc.band_table))


def test_compact_to_dense_kernel_matches_plain_fp64(band_plan):
    plan, rc, PB, _W, _G, gT, dbT = _f64(band_plan)
    args = (gT, rc.iru, rc.icu, dbT, rc.occ2, PB, plan.wg)
    got = _f64_counted("compact_to_dense",
                       lambda: segmm.compact_to_dense(*args, table=rc.dense_table))
    assert torch.equal(got, segmm.compact_to_dense_plain(*args))
    assert torch.equal(got, segmm.compact_to_dense(*args, table=rc.dense_table))


def test_band_transpose_kernel_matches_plain_fp64(cuda):
    PB = 256
    rng = np.random.default_rng(11)
    m4 = torch.from_numpy(rng.standard_normal((36, PB, PB))).to(cuda)
    occ = torch.from_numpy((rng.random(PB // 64 * PB // 128) < 0.5).astype(np.int32)).to(cuda)
    got = _f64_counted("band_transpose", lambda: segmm.band_transpose(m4, occ, PB))
    assert torch.equal(got, segmm.band_transpose_plain(m4, occ, PB))
    assert torch.equal(got, segmm.band_transpose(m4, occ, PB))


def test_build_reports_the_fp64_formation_kernels(kitti_plan):
    """The fp64 builds at the kitti00 launch and at the planner's largest
    kwin: schur_fused one block an SM, the placements at least four,
    none spilling."""
    sc = kitti_plan[0].schur
    big = segmm.SchurPlan(sc.chunk, sc.slot_block, 1024, 1, *([None] * 5), 0, 0, True)
    for name, launch, least in (
            ("schur_fused", segmm.schur_fused_launch(sc, torch.float64), 1),
            ("schur_fused", segmm.schur_fused_launch(big, torch.float64), 1),
            ("compact_to_band", segmm.compact_to_band_launch(kitti_plan[2]), 4),
            ("compact_to_dense", segmm.compact_to_dense_launch(kitti_plan[2]), 4)):
        attrs = segmm.kernel_attributes(name, launch, torch.float64)
        print(name, "fp64", launch, attrs)
        assert attrs["registers"] > 0 and attrs["blocks_per_sm"] >= least, (name, attrs)
        assert attrs["spill_bytes"] == 0, (name, attrs)


def _fp64_against_plain(prob, config, route, niters=4, edit=None):
    """The fp64 engine on the card against the same run with the plain
    versions: every launch an fp64 one, chi² within 1e-10 per iteration."""
    segmm.reset_launches()
    ba, got = _graph_run(prob, config, niters=niters, edit=edit)
    assert ba._engine.path == route
    launched = {n for n, c in segmm.LAUNCHES.items() if c}
    assert launched and all(segmm.LAUNCHES_F64[n] == segmm.LAUNCHES[n] for n in launched)
    with segmm.use_plain():
        _, want = _graph_run(prob, config, niters=niters, edit=edit)
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    assert got[-1] < got[0]
    return launched


def test_v2_band_fp64_on_card_matches_plain(cuda):
    launched = _fp64_against_plain(
        synthetic.generate(num_poses=150, num_landmarks=1400, seed=2),
        BAConfig(dtype=torch.float64, solver="band_cr", device="cuda"), "v2")
    assert {"schur_fused", "compact_to_band", "segsum", "gather"} <= launched


def test_v2_dense_fp64_on_card_matches_plain(cuda):
    """fp64 dense_cholesky: compact_to_dense in fp64, the solve by
    cholesky_ex and solve_triangular (no trisolve kernel)."""
    launched = _fp64_against_plain(
        synthetic.generate(num_poses=10, num_landmarks=90, seed=7),
        BAConfig(dtype=torch.float64, device="cuda"), "v2")
    assert "compact_to_dense" in launched
    assert not launched & {"extract_diag_blocks", "solve_lower", "solve_upper", "matvec"}


def test_v1_fp64_on_card_matches_plain(cuda, monkeypatch):
    monkeypatch.setattr(rows, "_WG_MAX", 0)
    launched = _fp64_against_plain(
        synthetic.generate(num_poses=150, num_landmarks=1400, seed=2),
        BAConfig(dtype=torch.float64, solver="band_cr", device="cuda"), "v1")
    assert {"schur_fused", "band_transpose"} <= launched


def test_pcg_fp64_on_card_matches_plain(cuda):
    launched = _fp64_against_plain(
        synthetic.generate(num_poses=40, num_landmarks=600, seed=4),
        BAConfig(dtype=torch.float64, solver="pcg", device="cuda"), "rows")
    assert {"gather", "segsum"} <= launched


def test_aos_fp64_on_card_matches_plain(cuda, monkeypatch):
    monkeypatch.setattr(rows, "plan_row_tables", lambda s, pad_blocks=0, lr=None: (None, None))
    launched = _fp64_against_plain(
        synthetic.generate(num_poses=40, num_landmarks=600, seed=4),
        BAConfig(dtype=torch.float64, device="cuda"), "aos")
    assert launched == {"segsum"}


# ---------------------------------------------------------------------------
# the landmark-sharded LM on the card (parallel/)
# ---------------------------------------------------------------------------


def _route_kernels(out, name):
    """``chip_smoke.expected_kernels`` of a rank's route facts for a case."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    facts = {k[len(name) + 1:]: v for k, v in out.items() if k.startswith(f"{name}.")}
    return chip_smoke.expected_kernels(facts)


def _mesh_case(name, config, **kw):
    ba = synthetic.build_graph(synthetic.generate(num_poses=140, num_landmarks=900, seed=13),
                               BAConfig(dtype=torch.float64, device="cpu"))
    ba.set_robust_kernels(RobustKernelType.HUBER, float(np.sqrt(5.991)), EdgeType.MONOCULAR)
    ba.initialize()
    return dict(name=name, kind="engine", structure=ba._engine.structure,
                kernels=tuple(ba._kernels), iters=5, config=config, **kw)


def test_mesh_one_rank_over_nccl_equals_single_device(cuda):
    """A world of one over NCCL: the shard is the whole graph and every
    all-reduce the identity, so the trajectory and the state are the
    single-device engine's bits (band_cr, fp32, the kernels on the card)."""
    from cuba_tpu_torch.parallel import drive, launch

    segmm.build_kernels()
    case = _mesh_case("s1", dict(dtype=torch.float32, solver="band_cr"), single=True)
    (r,) = launch.spawn(drive.run_cases, 1, backend="nccl", device="cuda", timeout=300,
                        args=([case],))
    assert str(r["s1.path"]) == "v2" and str(r["s1.solver"]) == "band_cr"
    for k in ("chis", "Xws", "qs", "ts", "final_lambda"):
        assert np.array_equal(r[f"s1.{k}"], r[f"s1.single.{k}"]), k
    launched = dict(zip(drive.LAUNCH_NAMES, r["s1.launches"]))
    assert all(launched[n] > 0 for n in _route_kernels(r, "s1"))


def test_spawn_defaults_to_the_card(cuda):
    """spawn with no ``device`` puts its rank on the card: the route's
    kernels launch there."""
    from cuba_tpu_torch.parallel import drive, launch

    segmm.build_kernels()
    case = _mesh_case("d1", dict(dtype=torch.float32, solver="band_cr"))
    (r,) = launch.spawn(drive.run_cases, 1, backend="nccl", timeout=300, args=([case],))
    launched = dict(zip(drive.LAUNCH_NAMES, r["d1.launches"]))
    assert all(launched[n] > 0 for n in _route_kernels(r, "d1"))


def test_mesh_four_ranks_over_gloo_on_one_card(cuda):
    """Four ranks on one card over gloo (CUDA tensors through its host
    staging): every rank's trajectory and state the same bits, within 5e-3
    of the single-device run, every kernel of the route launched on every
    rank."""
    from cuba_tpu_torch.parallel import drive, launch
    from cuba_tpu_torch.solver.engine import BlockSolverEngine

    segmm.build_kernels()
    case = _mesh_case("s4", dict(dtype=torch.float32, solver="band_cr"))
    res = launch.spawn(drive.run_cases, 4, backend="gloo", device="cuda", timeout=300,
                       args=([case],))
    single = BlockSolverEngine(case["structure"], case["kernels"],
                               BAConfig(dtype=torch.float32, solver="band_cr", device="cuda"))
    want = single.optimize(None, 5).chis
    for r in res:
        assert str(r["s4.path"]) == "v2" and not r["modules"].size
        for k in ("chis", "Xws", "qs"):
            assert np.array_equal(r[f"s4.{k}"], res[0][f"s4.{k}"]), k
        launched = dict(zip(drive.LAUNCH_NAMES, r["s4.launches"]))
        assert all(launched[n] > 0 for n in _route_kernels(r, "s4"))
    np.testing.assert_allclose(res[0]["s4.chis"], want, rtol=5e-3)


def test_mesh_aos_body_with_an_empty_shard_on_one_card(cuda):
    """The AoS shard body on the card where the last of four shards owns
    no active landmark (nine active of 48, landmarks 9.. fixed: the rows
    cut refuses), fp64: every rank the same bits, within 1e-6 of the
    single-device run, the CSR segment sum launched on every rank."""
    from cuba_tpu_torch.parallel import drive, launch
    from cuba_tpu_torch.solver.engine import BlockSolverEngine

    segmm.build_kernels()
    ba = synthetic.build_graph(synthetic.generate(num_poses=6, num_landmarks=48, seed=17),
                               BAConfig(dtype=torch.float64, device="cpu"))
    for j in range(9, 48):
        ba.landmark_vertex(j).fixed = True
    ba.initialize()
    case = dict(name="e", kind="engine", structure=ba._engine.structure,
                kernels=tuple(ba._kernels), iters=5, config=dict(dtype=torch.float64))
    res = launch.spawn(drive.run_cases, 4, backend="gloo", device="cuda", timeout=300,
                       args=([case],))
    single = BlockSolverEngine(case["structure"], case["kernels"],
                               BAConfig(dtype=torch.float64, device="cuda"))
    want = single.optimize(None, 5).chis
    for r in res:
        assert str(r["e.path"]) == "aos"
        for k in ("chis", "Xws", "qs"):
            assert np.array_equal(r[f"e.{k}"], res[0][f"e.{k}"]), k
        launched = dict(zip(drive.LAUNCH_NAMES, r["e.launches_f64"]))
        assert launched["segsum"] > 0
    np.testing.assert_allclose(res[0]["e.chis"], want, rtol=1e-6)


# the large-landmark regime (cuba_tpu_torch/tools/stress_large_l.py): its
# generator's arguments at 48 poses / 8,000 landmarks give a kwin-128 Schur
# plan, as the full 1778 / 1M graph does
_STRESS_SMALL = dict(num_poses=48, num_landmarks=8000, mean_obs_per_landmark=5.0,
                     stereo_fraction=0.25, seed=0)
_STRESS_EDGES, _STRESS_L, _STRESS_P = 3_885_457, 1_000_000, 1778


@pytest.fixture(scope="module")
def kwin128_plan():
    """The reduced stress graph's plan on the card (kwin 128), with seeded
    fp32 W / Hpl windows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cuba_tpu_torch.tools import graphs

    cuda = torch.device("cuda")
    s = graphs.structure_of(synthetic.generate(**_STRESS_SMALL))
    plan, rc = rows.plan_rows(s, cuda, torch.float32, pad_blocks=rows.pad_blocks_of(s.num_p))
    gen = torch.Generator(device=cuda).manual_seed(7)
    return plan, rc, *(torch.randn((18, plan.hpl_pad), generator=gen, device=cuda)
                       for _ in range(2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_schur_fused_kernel_follows_its_walk_at_kwin_128(kwin128_plan, dtype):
    """At kwin 128 (the stress plan's, one pass of 128 lanes a chunk) the
    kernel is ``walks.schur_fused_walk`` bit for bit, fp32 and fp64 (fp64
    on fp32 values, whose products are exact), launched once and the same
    bits on a relaunch; the build takes the launch's shared memory."""
    plan, rc, W, G = kwin128_plan
    sc = plan.schur
    assert sc.kwin == 128
    W, G = W.to(dtype), G.to(dtype)
    args = (sc, rc.sc_sb, rc.sc_li, rc.sc_lj, rc.sc_lk)
    before = (segmm.LAUNCHES["schur_fused"], segmm.LAUNCHES_F64["schur_fused"])
    got = segmm.schur_fused(W, G, *args, csr=rc.csr_sc)
    torch.cuda.synchronize()
    f64 = int(dtype == torch.float64)
    assert (segmm.LAUNCHES["schur_fused"], segmm.LAUNCHES_F64["schur_fused"]) == (
        before[0] + 1, before[1] + f64)
    want = walks.schur_fused_walk(W.cpu().numpy(), G.cpu().numpy(), *_walk_args(plan, rc))
    ints = np.int64 if f64 else np.int32
    assert want.dtype == got.cpu().numpy().dtype
    assert np.array_equal(got.cpu().numpy().view(ints), want.view(ints))
    assert torch.equal(got, segmm.schur_fused(W, G, *args, csr=rc.csr_sc))
    launch = segmm.schur_fused_launch(sc, dtype)
    attrs = segmm.kernel_attributes("schur_fused", launch, dtype)
    assert attrs["blocks_per_sm"] >= 1 and attrs["spill_bytes"] == 0, (launch, attrs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stress_shaped_gathers_and_sums_match_plain(cuda, dtype):
    """The gathers and segment sums at the stress graph's widths (N =
    3,885,457 edges, 1,000,000 landmarks, 1778 poses): the landmark fetch
    [3, 1M] -> [3, N] and the pose fetch [12, 2048] -> [12, N] bit for bit;
    the landmark sums [18, N] -> [18, 1M] (~4 entries a segment) and the
    pose sums [42, N] -> [42, 1778] (~2,200 a segment) within 1e-5 (fp64:
    1e-13) of each output's sum of |terms|."""
    rng = np.random.default_rng(18)
    N = _STRESS_EDGES
    lm = np.sort(rng.integers(0, _STRESS_L, N)).astype(np.int32)
    pose = rng.integers(0, _STRESS_P, N).astype(np.int32)
    lm[rng.random(N) < 0.01] = -1
    lm_ids, pose_ids = torch.from_numpy(lm).to(cuda), torch.from_numpy(pose).to(cuda)
    xw = torch.randn((3, _STRESS_L), dtype=dtype, device=cuda)
    psrc = torch.randn((12, 2048), dtype=dtype, device=cuda)
    for src, ids in ((xw, lm_ids), (psrc, pose_ids)):
        assert torch.equal(segmm.gather(src, ids), segmm.gather_plain(src, ids))
    rtol = 1e-13 if dtype == torch.float64 else 1e-5
    for D, ids, num_out, name in ((18, lm_ids, _STRESS_L, "landmark sums"),
                                  (42, pose_ids, _STRESS_P, "pose sums")):
        vals = torch.randn((D, N), dtype=dtype, device=cuda)
        csr = segmm.segment_csr(ids, num_out, cuda)
        before = segmm.LAUNCHES["segsum"]
        got = segmm.segsum(vals, ids, num_out, csr)
        torch.cuda.synchronize()
        assert segmm.LAUNCHES["segsum"] == before + 1
        want = segmm.segsum_plain(vals, ids, num_out)
        bound = segmm.segsum_plain(vals.abs(), ids, num_out)
        assert bool(((got - want).abs() <= rtol * bound).all()), name
        del vals, got, want, bound


def test_crossover_out_of_memory_row(cuda):
    """The crossover's out-of-memory row on the card: with the allocator
    held to 64 MB above what the process holds, the dense solve at P = 1024
    (a 6144^2 fp32 matrix, 151 MB) runs out of memory: the row carries the
    error and no wall; with the limit lifted the same row runs."""
    import argparse

    from cuba_tpu_torch.tools import bench_pcg_crossover as bx

    args = argparse.Namespace(iters=2, trials=1, device="cuda", dtype="float32")
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.set_per_process_memory_fraction(
        (torch.cuda.memory_reserved() + (64 << 20)) / total)
    try:
        r = bx.row(1024, 1024 * 15, "dense_cholesky", args)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    assert r["error"].startswith("OutOfMemoryError") and "wall_s" not in r, r
    r = bx.row(1024, 1024 * 15, "dense_cholesky", args)
    assert "error" not in r and r["wall_s"] > 0 and r["descended"], r


# the crossover's dense solve at P = 8192: n = 49152, n^2 = 2.4G elements,
# past int32; the kernels offset rows in int64
_BIG_N = 6 * 8192


@pytest.fixture(scope="module")
def big_lower():
    """A seeded lower-triangular L at n = 49152 (unit diagonal, strictly
    lower entries in [0, 0.5/n): well conditioned), its inverted diagonal
    blocks and a right-hand side, made on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda = torch.device("cuda")
    n = _BIG_N
    gen = torch.Generator(device=cuda).manual_seed(49)
    L = torch.rand((n, n), generator=gen, device=cuda).mul_(0.5 / n).tril_(-1)
    L.diagonal().fill_(1.0)
    with segmm.use_plain():
        invd = trisolve.prepare(L)
    yield L, invd, torch.randn(n, generator=gen, device=cuda)
    del L, invd
    torch.cuda.empty_cache()


def test_trisolve_kernels_past_int32_elements(big_lower):
    """At n = 49152 (2.4G elements of L): the diagonal copy bit for bit, the
    two sweeps within 1e-5 of max |result| of their plain versions, the
    matvec within 1e-5 of each row's sum of |terms|, one launch each."""
    L, invd, v = big_lower
    assert L.numel() > 2 ** 31
    before = dict(segmm.LAUNCHES)
    assert torch.equal(trisolve.extract_diag_blocks(L), trisolve.extract_diag_blocks_plain(L))
    for name in ("solve_lower", "solve_upper"):
        got = getattr(trisolve, name)(L, invd, v)
        want = getattr(trisolve, name + "_plain")(L, invd, v)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()), name
    got = trisolve.matvec(L, v)
    bound = 1e-5 * (L.abs() @ v.abs())
    assert bool(((got - trisolve.matvec_plain(L, v)).abs() <= bound).all())
    torch.cuda.synchronize()
    for name in ("extract_diag_blocks", "solve_lower", "solve_upper", "matvec"):
        assert segmm.LAUNCHES[name] == before[name] + 1, name


def test_compact_to_dense_past_int32_elements(cuda):
    """PB = 8192 (a [49152, 49152] output, 2.4G elements): the diagonal
    blocks, the first upper diagonal and a long-range block of every row
    below PB/2 placed, bit for bit the plain version, the last rows
    included."""
    PB = 8192
    M = PB // 64
    p = np.arange(PB)
    r = np.concatenate([p, p[:-1], p[: PB // 2 - 1]])
    c = np.concatenate([p, p[1:], PB - 1 - p[: PB // 2 - 1]])
    Wg = -(-r.size // (M * 128)) * 128
    iru = np.full(M * Wg, -1, np.int32)
    icu = np.full(M * Wg, -1, np.int32)
    iru[: r.size], icu[: r.size] = r, c
    gen = torch.Generator(device=cuda).manual_seed(8)
    gT = torch.randn((36, M * Wg), generator=gen, device=cuda)
    dbT = torch.randn((36, PB), generator=gen, device=cuda)
    occ2 = torch.ones(PB // 64 * (PB // 128), dtype=torch.int32, device=cuda)
    table = torch.from_numpy(segmm.dense_table(iru, icu, PB)).to(cuda)
    args = (gT, torch.from_numpy(iru).to(cuda), torch.from_numpy(icu).to(cuda), dbT, occ2, PB,
            Wg)
    before = segmm.LAUNCHES["compact_to_dense"]
    got = segmm.compact_to_dense(*args, table=table)
    torch.cuda.synchronize()
    assert got.numel() > 2 ** 31 and segmm.LAUNCHES["compact_to_dense"] == before + 1
    assert torch.equal(got, segmm.compact_to_dense_plain(*args))
    assert torch.equal(got[-6:, -6:], -gT[:, PB - 1].reshape(6, 6) + dbT[:, PB - 1].reshape(6, 6))


# the port's tools (cuba_tpu_torch/tools/), each main on the card at a
# small size: the argv and a line its output must hold
_TOOLS_SMALL = {
    "profile_formation": (["--poses", "130", "--landmarks", "3000", "--reps", "2"],
                          "marginals (device ms)"),
    "profile_crsolve": ([], "host reads of one cr_solve: 1"),
    "perf_probe_solve": (["--n", "1536", "--reps", "2"], "solve rel err refine=2"),
    "bench_pcg_band_mc": (["--poses", "130", "--landmarks", "3000", "--reps", "2"],
                          "crossover: sharded PCG"),
    "bench_multichip_mxu": (["--poses", "40", "--landmarks", "800", "--trials", "1", "--iters",
                             "3"], "equals the single-device one bit for bit"),
    "mc_parity": (["--poses", "40", "--landmarks", "800"], "-> OK"),
}


@pytest.mark.parametrize("tool", sorted(_TOOLS_SMALL))
def test_tool_runs_on_the_card(cuda, tool, capsys):
    """Each tool's ``main`` on the card (its default device) at a small
    size: exit 0, device times in its tables, the card named."""
    import importlib

    module = importlib.import_module(f"cuba_tpu_torch.tools.{tool}")
    argv, line = _TOOLS_SMALL[tool]
    assert module.main(argv) == 0
    out = capsys.readouterr().out
    assert line in out and torch.cuda.get_device_name(0).split()[0] in out


def test_parity_kitti00_fp64_record_on_the_card(cuda, tmp_path, monkeypatch):
    """``parity_kitti00 --phase fp64`` on the card and on the host at 24 P
    / 600 L: one record keyed by device, the card's fp64 trajectories
    within 1e-6 of the host's a step."""
    import json

    from cuba_tpu_torch.tools import parity_kitti00

    monkeypatch.setattr(parity_kitti00, "RECORD", str(tmp_path / "record.json"))
    size = ["--poses", "24", "--landmarks", "600"]
    assert parity_kitti00.main(["--phase", "fp64"] + size) == 0
    assert parity_kitti00.main(["--phase", "fp64", "--device", "cpu"] + size) == 0
    rec = json.loads((tmp_path / "record.json").read_text())
    assert len(rec) == 3
    for by_device in rec.values():
        card, host = by_device["cuda"]["chis"], by_device["cpu"]["chis"]
        assert len(card) == len(host) == 10
        np.testing.assert_allclose(card, host, rtol=1e-6)
