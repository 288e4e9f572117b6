"""The port's v2 band Schur formation against cuba_tpu's, on CPU.

The plan is real: the 150-pose / 1,400-landmark problem of
tests/test_band_cr.py (its test of ``schur_band_mxu``), planned by both
packages.  The values (W, Hpl, the compact table, the damped diagonal) are
seeded numpy draws handed to both.  cuba_tpu's Pallas kernels run in
interpret mode.  The CUDA kernels cannot run here; the tables they read
(the per-lane CSR of ``schur_fused`` and the placement table of
``compact_to_band``) are checked by a numpy walk of the kernels' own index
arithmetic.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuba_tpu.io import synthetic as tpu_synthetic
from cuba_tpu.ops import segmm as tpu_segmm
from cuba_tpu.solver import engine as tpu_engine
from cuba_tpu.solver import mxu
from cuba_tpu.solver import structure as tpu_structure
from cuba_tpu_torch.interop import structure_from_numpy
from cuba_tpu_torch.ops import segmm, walks
from cuba_tpu_torch.solver import rows

torch.set_num_threads(1)

# each output within this share of its sum of |products| (fp32 sums in
# another order)
SUM_RTOL = 1e-5


@pytest.fixture(scope="module")
def band_problem():
    num_p, num_l = 150, 1400
    prob = tpu_synthetic.generate(num_poses=num_p, num_landmarks=num_l, seed=2)
    fp = np.zeros(num_p, bool)
    fp[prob.fixed_poses] = True
    s = tpu_structure.build_structure_from_arrays(
        prob.qs, prob.ts, np.tile(prob.cam, (num_p, 1)), prob.Xws, fp, np.zeros(num_l, bool),
        prob.mono_p, prob.mono_l, prob.mono_z, prob.mono_w,
        prob.stereo_p, prob.stereo_l, prob.stereo_z, prob.stereo_w,
    )
    PB = tpu_engine._pad_blocks(s.num_p)
    plans, consts = mxu.plan_mxu(s, PB, need_dense=True, wire_pack=False)
    assert plans.ok and plans.v2
    plan, rc = rows.plan_rows(structure_from_numpy(s), "cpu", torch.float32, pad_blocks=PB)
    rng = np.random.default_rng(11)
    H = plan.hpl_pad
    W = (rng.standard_normal((18, H)) * 0.3).astype(np.float32)
    G = (rng.standard_normal((18, H)) * 0.3).astype(np.float32)
    return s, PB, plans, consts, plan, rc, W, G


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _sc_args(plan, rc):
    return plan.schur, rc.sc_sb, rc.sc_li, rc.sc_lj, rc.sc_lk


@pytest.fixture(scope="module")
def pallas_schur(band_problem):
    """cuba_tpu's Pallas schur_fused in interpret mode on the fixture's W, G."""
    _s, _PB, plans, consts, _plan, _rc, W, G = band_problem
    return np.asarray(tpu_segmm.schur_fused(
        jnp.asarray(W), jnp.asarray(G), plans.schur, jnp.asarray(consts.sc_sb),
        jnp.asarray(consts.sc_li), jnp.asarray(consts.sc_lj), jnp.asarray(consts.sc_lk),
        interpret=True))


def test_schur_fused_plain_matches_pallas_and_xla(band_problem, pallas_schur):
    s, _PB, plans, consts, plan, rc, W, G = band_problem
    got = segmm.schur_fused(_t(W), _t(G), *_sc_args(plan, rc)).numpy()
    bound = SUM_RTOL * segmm.schur_fused_plain(_t(np.abs(W)), _t(np.abs(G)),
                                               *_sc_args(plan, rc)).numpy()
    want = pallas_schur
    assert got.shape == want.shape == (36, plan.schur.num_chunks * plan.schur.kwin)
    assert np.all(np.abs(got - want) <= bound + 1e-30)
    # per Hsc block (the lanes combined by their global block ids) against
    # the XLA reference over the unsorted triplets
    gid = torch.from_numpy(np.asarray(plan.schur.gid, np.int32))
    per_block = segmm.segsum_plain(_t(got), gid, s.n_hsc).numpy()
    xla = np.asarray(tpu_segmm.schur_fused_xla(jnp.asarray(W), jnp.asarray(G),
                                               s.mul_i, s.mul_j, s.mul_k, s.n_hsc))
    bound_b = segmm.segsum_plain(_t(bound), gid, s.n_hsc).numpy()
    assert np.all(np.abs(per_block - xla) <= bound_b + 1e-30)


def test_schur_lane_csr_walk_matches_plain(band_problem):
    """The order schur_fused's kernel sums in (one lane's CSR segment,
    its triplets' windowed ids), walked in numpy, gives the plain sums."""
    _s, _PB, _plans, _consts, plan, rc, W, G = band_problem
    sc = plan.schur
    order, offs = rc.csr_sc.order.numpy(), rc.csr_sc.offs.numpy()
    li, lj, sb = (a.numpy() for a in (rc.sc_li, rc.sc_lj, rc.sc_sb))
    lanes = sc.num_chunks * sc.kwin
    out = np.zeros((36, lanes), np.float64)
    for lane in range(lanes):
        t = order[offs[lane]:offs[lane + 1]]
        base = int(sb[lane // sc.kwin]) * sc.slot_block
        w = W[:, base + li[t]].reshape(6, 3, -1).astype(np.float64)
        g = G[:, base + lj[t]].reshape(6, 3, -1).astype(np.float64)
        out[:, lane] = np.einsum("akt,bkt->ab", w, g).reshape(36)
    plain = segmm.schur_fused(_t(W), _t(G), *_sc_args(plan, rc)).numpy()
    bound = SUM_RTOL * segmm.schur_fused_plain(_t(np.abs(W)), _t(np.abs(G)),
                                               *_sc_args(plan, rc)).numpy()
    assert np.all(np.abs(out - plain) <= bound + 1e-30)
    assert offs[-1] == int((np.asarray(sc.lk) >= 0).sum())


@pytest.mark.parametrize("ref", ["pallas", "plain"])
def test_schur_fused_walk_matches_reference(band_problem, pallas_schur, ref):
    """The CUDA kernel's order (per lane, CSR order, three FMAs a triplet)
    walked in NumPy: within 1e-5 of each output's sum of |terms| of
    cuba_tpu's Pallas kernel in interpret mode and of the plain version;
    empty lanes 0."""
    _s, _PB, _plans, _consts, plan, rc, W, G = band_problem
    sc = plan.schur
    walk = walks.schur_fused_walk(W, G, sc, rc.sc_sb, rc.sc_li, rc.sc_lj, rc.csr_sc)
    want = pallas_schur if ref == "pallas" else segmm.schur_fused_plain(
        _t(W), _t(G), *_sc_args(plan, rc)).numpy()
    bound = SUM_RTOL * segmm.schur_fused_plain(_t(np.abs(W)), _t(np.abs(G)),
                                               *_sc_args(plan, rc)).numpy()
    assert walk.shape == want.shape == (36, sc.num_chunks * sc.kwin)
    assert np.all(np.abs(walk - want) <= bound + 1e-30)
    empty = np.diff(rc.csr_sc.offs.numpy()) == 0
    assert empty.any() and np.all(walk[:, empty] == 0)


def test_schur_fused_walk_is_the_fma_chain(band_problem):
    """One lane by hand: s = fma(W[3a+m, i], G[3b+m, j], s) for m = 0, 1, 2
    over its triplets in ascending position, each FMA rounded once."""
    _s, _PB, _plans, _consts, plan, rc, W, G = band_problem
    sc = plan.schur
    offs, order = rc.csr_sc.offs.numpy(), rc.csr_sc.order.numpy()
    lane = int(np.argmax(np.diff(offs)))  # the longest lane
    t = order[offs[lane]:offs[lane + 1]]
    assert t.size > 1 and np.all(np.diff(t) > 0)
    base = int(rc.sc_sb[lane // sc.kwin]) * sc.slot_block
    want = np.zeros(36, np.float32)
    for tt in t:
        i, j = base + int(rc.sc_li[tt]), base + int(rc.sc_lj[tt])
        for a in range(6):
            for b in range(6):
                s = want[a * 6 + b]
                for m in range(3):
                    s = np.float32(np.float64(W[3 * a + m, i]) * np.float64(G[3 * b + m, j])
                                   + np.float64(s))
                want[a * 6 + b] = s
    walk = walks.schur_fused_walk(W, G, sc, rc.sc_sb, rc.sc_li, rc.sc_lj, rc.csr_sc)
    # fp64 product + sum, rounded once to fp32, is fp32's FMA but for double
    # rounding ties, which these draws do not hit
    np.testing.assert_array_equal(walk[:, lane], want)


@pytest.mark.parametrize("chunk", [1024, 2048])
@pytest.mark.parametrize("kwin", [128, 256, 1024])
def test_schur_fused_launch(chunk, kwin):
    """One block per chunk of 256 threads; the shared bytes of the windows,
    the chunk's pairs, offsets and lane order and the output tile: at chunk 1024
    and kwin 256, the kitti00 plan's, two blocks share an SM (at most
    113 KB each of the H100's 228 KB)."""
    plan = segmm.SchurPlan(chunk, 256, kwin, 7, *([None] * 5), 0, 0, True)
    launch = segmm.schur_fused_launch(plan)
    windows = 2 * 512 * 20 * 4  # slot-major: a slot's 18 values padded to 5 float4
    ints = 4 * (-(-(chunk + 2 * kwin + 1) // 4) * 4)  # pairs, lane offsets, lane order
    tile = 36 * (segmm.SCHUR_PASS + 4) * 4
    assert launch == dict(grid=[7], threads=256, smem=windows + ints + tile)
    assert kwin % segmm.SCHUR_PASS == 0 and launch["smem"] <= 232448
    if (chunk, kwin) == (1024, 256):
        assert launch["smem"] <= 113 * 1024
    assert segmm.SCHUR_SLOT % 4 == 0 and segmm.SCHUR_SLOT >= 18
    # the windows' 16-byte loads split evenly over the block's threads, and
    # six threads take each lane of a pass
    assert 36 * segmm.SCHUR_WINDOW // 4 % segmm.SCHUR_THREADS == 0
    assert 6 * segmm.SCHUR_PASS % segmm.SCHUR_THREADS == 0


def test_schur_staging_places_every_float_once():
    """The windows' staging: every float4 of the two [18, 512] windows is
    loaded once, a warp's 32 loads are 16 bytes of each of 32 consecutive
    rows (mod 36), every float lands once in its slot-major word (value
    r % 18 of slot 4*q4 + c), and a store puts at most three threads of a
    warp on one shared bank."""
    r, q4, words = walks.schur_stage_walk()
    assert r.shape == (18, 256)
    pairs = set(zip(r.ravel().tolist(), q4.ravel().tolist()))
    assert len(pairs) == r.size == 36 * 128
    lane_rows = r.reshape(18, 8, 32)
    assert np.all((np.diff(lane_rows, axis=-1) - 1) % 36 == 0)
    assert np.unique(words).size == words.size == 2 * 18 * 512
    win = 512 * segmm.SCHUR_SLOT
    slot, val = words % win // segmm.SCHUR_SLOT, words % segmm.SCHUR_SLOT
    np.testing.assert_array_equal(slot, 4 * q4[..., None] + np.arange(4))
    np.testing.assert_array_equal(val, np.broadcast_to((r % 18)[..., None], val.shape))
    np.testing.assert_array_equal(words >= win, np.broadcast_to((r >= 18)[..., None], words.shape))
    banks = words.reshape(18, 8, 32, 4) % 32
    for c in range(4):
        worst = max(np.bincount(b, minlength=32).max() for b in banks[..., c].reshape(-1, 32))
        assert worst <= 3


def test_schur_lane_csr_pairs(band_problem):
    """The per-lane CSR that plan_rows builds once per structure carries
    the kernel's pair table: li | lj << 16 of each entry's triplet, -1
    where li or lj lies outside the 512-slot window."""
    _s, _PB, _plans, _consts, plan, rc, _W, _G = band_problem
    sc = plan.schur
    order, pairs = rc.csr_sc.order.numpy(), rc.csr_sc.pairs.numpy()
    li, lj = np.asarray(sc.li)[order], np.asarray(sc.lj)[order]
    assert pairs.dtype == np.int32 and pairs.shape == order.shape
    ok = (li >= 0) & (lj >= 0) & (li < 512) & (lj < 512)
    assert ok.all()  # a feasible plan keeps every triplet inside its window
    np.testing.assert_array_equal(pairs, li | (lj << 16))
    again = segmm.schur_lane_csr(sc, "cpu")
    for name in ("order", "offs", "pairs"):
        assert torch.equal(getattr(again, name), getattr(rc.csr_sc, name))
    li_bad = np.where(np.arange(sc.li.size) == order[0], 600, sc.li).astype(np.int32)
    assert int(segmm.schur_lane_csr(dataclasses.replace(sc, li=li_bad), "cpu").pairs[0]) == -1


def test_schur_lane_order(band_problem):
    """The kernel's lane order: each group of 128 lanes of a chunk, as local
    lane ids, a permutation of the group by descending length, ties by
    lane."""
    _s, _PB, _plans, _consts, plan, rc, _W, _G = band_problem
    sc = plan.schur
    lengths = np.diff(rc.csr_sc.offs.numpy())
    got = rc.csr_sc.lane_order.numpy()
    assert got.shape == (sc.num_chunks * sc.kwin,) and got.dtype == np.int32
    assert np.array_equal(got, segmm.schur_lane_order(lengths, sc.kwin))
    for c in range(sc.num_chunks):
        for g0 in range(0, sc.kwin, 128):
            ids = got[c * sc.kwin + g0:c * sc.kwin + g0 + 128]
            assert np.array_equal(np.sort(ids), np.arange(g0, g0 + 128))
            key = list(zip(-lengths[c * sc.kwin + ids], ids))
            assert key == sorted(key)
    assert lengths[sc.kwin * np.arange(sc.num_chunks)[:, None] + got.reshape(
        sc.num_chunks, -1)[:, :1]].max() == lengths.max()


def _compact_inputs(plan, PB, seed):
    rng = np.random.default_rng(seed)
    M = PB // 64
    gT = rng.standard_normal((36, M * plan.wg)).astype(np.float32)
    dbT = rng.standard_normal((36, PB)).astype(np.float32)
    return gT, dbT


def test_compact_to_band_plain_matches_pallas(band_problem):
    _s, PB, plans, consts, plan, rc, _W, _G = band_problem
    gT, dbT = _compact_inputs(plan, PB, 3)
    got = segmm.compact_to_band(_t(gT), rc.iru, rc.icu, _t(dbT), rc.band_occ, PB,
                                plan.wg).numpy()
    want = np.asarray(tpu_segmm.compact_to_band(
        jnp.asarray(gT), jnp.asarray(consts.iru), jnp.asarray(consts.icu), jnp.asarray(dbT),
        jnp.asarray(consts.band_occ), PB, plans.wg, interpret=True))
    assert got.shape == want.shape == (PB // 64 * 384, 768)
    # a placement: the Pallas kernel's exact one-hot selections give the
    # same values
    np.testing.assert_array_equal(got, want)


def test_band_table_walk_matches_plain(band_problem):
    """compact_to_band's kernel index arithmetic over the placement table,
    walked in numpy, gives the plain version bit for bit."""
    _s, PB, _plans, _consts, plan, rc, _W, _G = band_problem
    gT, dbT = _compact_inputs(plan, PB, 4)
    M = PB // 64
    tab = rc.band_table.numpy()
    occ = rc.band_occ.numpy()
    R, C = np.meshgrid(np.arange(M * 384), np.arange(768), indexing="ij")
    k, rl = R // 384, R % 384
    pr, i = rl // 6, rl % 6
    e, cl = C // 384, C % 384
    lq, j = e * 64 + cl // 6, cl % 6
    p = k * 64 + pr
    ent = tab[p, lq]
    slot = ent & ((1 << 30) - 1)
    row = np.where(ent & (1 << 30), j * 6 + i, i * 6 + j)
    v = np.where(ent >= 0, -gT[row, np.where(ent >= 0, slot, 0)], np.float32(0))
    v = np.where(lq == pr, v + dbT[i * 6 + j, p], v)
    v = np.where(occ[2 * k + e] > 0, v, np.float32(0)).astype(np.float32)
    plain = segmm.compact_to_band_plain(_t(gT), rc.iru, rc.icu, _t(dbT), rc.band_occ, PB,
                                        plan.wg).numpy()
    np.testing.assert_array_equal(v, plain)


@pytest.mark.parametrize("occ", ["planned", "one tile empty", "all empty"])
def test_compact_to_band_walk_matches_plain(band_problem, occ):
    """compact_to_band's kernel, block (pose row, tile column) by block and
    thread by thread (the strip, then its float4 rows), walked in NumPy:
    the plain version bit for bit, with the planned occupancy and with
    tiles marked empty."""
    _s, PB, _plans, _consts, plan, rc, _W, _G = band_problem
    gT, dbT = _compact_inputs(plan, PB, 7)
    occ_band = rc.band_occ.clone()
    if occ == "one tile empty":
        occ_band[int(np.flatnonzero(occ_band.numpy() > 0)[0])] = 0
    elif occ == "all empty":
        occ_band[:] = 0
    walk = walks.compact_to_band_walk(gT, rc.band_table.numpy(), dbT, occ_band.numpy(), PB)
    plain = segmm.compact_to_band_plain(_t(gT), rc.iru, rc.icu, _t(dbT), occ_band, PB,
                                        plan.wg).numpy()
    np.testing.assert_array_equal(walk.view(np.int32), plain.view(np.int32))
    assert np.any(walk != 0) == (occ != "all empty")


def test_compact_to_band_launch():
    """A block per (pose row, tile column), 192 threads, 9,472 B of static
    shared memory: each thread 12 placements and 3 float4 stores."""
    launch = segmm.compact_to_band_launch(1408)
    assert launch == dict(grid=[1408, 2], threads=192, smem=4 * (6 * 384 + 64))
    assert 36 * 64 % launch["threads"] == 0 and 6 * 96 % launch["threads"] == 0


@pytest.mark.parametrize("case", ["W narrower than n_slot_pad", "G wider than W",
                                  "lk shorter than the plan", "gT narrower than M*Wg",
                                  "iru shorter than M*Wg", "dbT narrower than PB"])
def test_wrappers_refuse_input_that_does_not_fit_the_plan(band_problem, case):
    """The wrappers check their shapes against the plan on every device:
    the kernels would drop or read past what does not fit."""
    _s, PB, _plans, _consts, plan, rc, W, G = band_problem
    gT, dbT = _compact_inputs(plan, PB, 6)
    sc = plan.schur
    Wt, Gt, lk = _t(W), _t(G), rc.sc_lk
    band = [_t(gT), rc.iru, rc.icu, _t(dbT)]
    if case == "W narrower than n_slot_pad":
        Wt = Gt = Wt[:, :sc.n_slot_pad - 1].contiguous()
    elif case == "G wider than W":
        Gt = torch.cat([Gt, Gt[:, :1]], dim=1)
    elif case == "lk shorter than the plan":
        lk = lk[:-1]
    elif case == "gT narrower than M*Wg":
        band[0] = band[0][:, :-1].contiguous()
    elif case == "iru shorter than M*Wg":
        band[1] = band[1][:-1]
    else:
        band[3] = band[3][:, :-1].contiguous()
    with pytest.raises(ValueError, match="do not fit|differ|expected|do not match"):
        if case.split()[0] in ("W", "G", "lk"):
            segmm.schur_fused(Wt, Gt, sc, rc.sc_sb, rc.sc_li, rc.sc_lj, lk)
        else:
            segmm.compact_to_band(*band, rc.band_occ, PB, plan.wg)


def test_band_formation_matches_schur_band_mxu(band_problem):
    s, PB, plans, consts, plan, rc, W, G = band_problem
    rng = np.random.default_rng(5)
    HppT = rng.standard_normal((42, s.num_p)).astype(np.float32)
    lam = np.float32(1e-4)
    mc = jax.tree_util.tree_map(jnp.asarray, consts)
    D2, U2 = mxu.schur_band_mxu(jnp.asarray(HppT), jnp.asarray(W), jnp.asarray(G), lam,
                                s.num_p, PB, plans, mc, jnp.float32, interpret=True)
    D, U = rows.schur_band(_t(HppT), _t(W), _t(G), torch.tensor(lam), s.num_p, plan, rc)
    np.testing.assert_allclose(D.numpy(), np.asarray(D2), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(U.numpy(), np.asarray(U2), rtol=1e-5, atol=1e-5)
