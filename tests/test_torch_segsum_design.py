"""The CUDA segment sum's design, checked on the CPU: the group width the
planner records for each call site, and the kernel's summation order.

The kernel (``csrc/segmm.cu`` ``segsum_csr``) cannot run here.  What fixes
its bits is host data and an order: the CSR and its group width G, built
once per structure, and the walk lane k = entries k, k+G, ... of a segment,
then a xor butterfly over the G partials.  ``walks.segsum_walk`` is that
order in NumPy; the card's tests hold the kernel to it bit for bit.  Here
it is held, in fp32, within 1e-5 of each output's sum of |terms| of the
plain version and of cuba_tpu's Pallas ``accum_segsum`` in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuba_tpu.ops import segmm as tpu
from cuba_tpu_torch.io import synthetic
from cuba_tpu_torch.ops import segmm, walks
from cuba_tpu_torch.solver import rows, structure

torch.set_num_threads(1)

SUM_RTOL = 1e-5


@pytest.mark.parametrize("mean,group", [
    (0.0, 1),  # all empty
    (0.747, 1),  # kitti00 Hpl slots: 0.75 per slot
    (1.243, 1),  # 1.2 per landmark
    (3.729, 1),  # 3.7 per landmark
    (4.0, 1),  # exactly four per segment: four per lane
    (4.01, 2),
    (4.968, 2),  # Hpl slots per landmark
    (12.05, 4),  # the v2 combine: 12.05 per block
    (106.7, 32),  # kitti00 stereo edges per pose
    (113.9, 32),  # AoS triplets per Schur block
    (128.0, 32),  # exactly 32 lanes of four
    (427.0, 32),  # kitti00 Hpl slots per pose, capped
    (9.9, 4),  # the v1 combines' occupied blocks
])
def test_group_width_rule(mean, group):
    assert segmm.group_width(mean) == group


def test_segment_csr_records_its_group_width():
    """The CSR's group width follows the mean length of the segments the
    kernel walks: all of them, or the listed ones."""
    ids = np.repeat(np.arange(10), 64).astype(np.int32)
    assert segmm.segment_csr(ids, 10, "cpu").group == 16  # 64 per segment
    assert segmm.segment_csr(np.arange(640) // 128, 5, "cpu").group == 32
    assert segmm.segment_csr(np.arange(640) // 32, 20, "cpu").group == 8
    assert segmm.segment_csr(np.arange(640) // 8, 80, "cpu").group == 2
    assert segmm.segment_csr(np.arange(640) % 640, 640, "cpu").group == 1  # one per segment
    # 99 of 100 segments empty: the width follows the listed ones
    assert segmm.segment_csr(ids, 1000, "cpu").group == 16
    assert segmm.segment_csr(np.full(64, -1, np.int32), 50, "cpu").group == 1


def test_segment_csr_lists_the_live_segments_where_most_are_empty():
    """A CSR lists its non-empty segments where more than 97% are empty and
    the listed ones take a wider group than all of them would."""
    ids = np.repeat(np.arange(10), 40).astype(np.int32)
    assert segmm.segment_csr(ids, 300, "cpu").live is None  # 96.7% empty
    csr = segmm.segment_csr(ids[::-1].copy(), 1000, "cpu")  # 99% empty
    np.testing.assert_array_equal(csr.live.numpy(), np.arange(10))
    assert csr.live.dtype == torch.int32
    # one entry per occupied segment: the same group either way, no list
    assert segmm.segment_csr(np.arange(10, dtype=np.int32), 1000, "cpu").live is None
    assert segmm.segment_csr(np.full(64, -1, np.int32), 50, "cpu").live is None


def _structure(num_p=150, num_l=1400, seed=2):
    prob = synthetic.generate(num_poses=num_p, num_landmarks=num_l, seed=seed)
    fp = np.zeros(num_p, bool)
    fp[prob.fixed_poses] = True
    return structure.build_structure_from_arrays(
        prob.qs, prob.ts, np.tile(prob.cam, (num_p, 1)), prob.Xws, fp, np.zeros(num_l, bool),
        prob.mono_p, prob.mono_l, prob.mono_z, prob.mono_w,
        prob.stereo_p, prob.stereo_l, prob.stereo_z, prob.stereo_w)


def _csrs(rc):
    return {name: getattr(rc, name) for name in dir(rc)
            if name.startswith("csr_") and getattr(rc, name) is not None}


@pytest.mark.parametrize("formation", ["v2", "v1"])
def test_planner_records_the_rule_at_every_site(formation, monkeypatch):
    if formation == "v1":
        monkeypatch.setattr(rows, "_WG_MAX", 0)  # close the v2 gate
    s = _structure()
    plan, rc = rows.plan_rows(s, "cpu", torch.float32, pad_blocks=rows.pad_blocks_of(s.num_p))
    assert plan.v2 == (formation == "v2")
    csrs = _csrs(rc)
    for name, csr in csrs.items():
        offs = csr.offs.numpy()
        walked = offs.size - 1 if csr.live is None else csr.live.numel()
        assert csr.group == segmm.group_width(offs[-1] / walked if walked else 0.0), name
    assert csrs["csr_pose_m"].group == 8  # ~25 edges per pose
    assert csrs["csr_e2h_m"].group == 1  # at most one edge per Hpl slot
    if formation == "v1":
        for name in ("csr_up", "csr_lo"):  # PB^2 blocks, nearly all empty
            csr = csrs[name]
            lengths = np.diff(csr.offs.numpy())
            live = np.flatnonzero(lengths)
            assert live.size < (1 - segmm.SPARSE_EMPTY) * lengths.size
            # listed exactly where the occupied blocks take a wider group
            # (here ~1.6 entries each, so not; kitti00's ~10 are)
            wider = segmm.group_width(lengths.sum() / live.size) > segmm.group_width(
                lengths.mean())
            assert (csr.live is not None) == wider
            if wider:
                np.testing.assert_array_equal(csr.live.numpy(), live)
    else:
        assert "csr_up2" in csrs


def _skewed_segments(rng):
    """ids over 64 segments: empty ones, length-1 ones, one of 500, and a
    geometric tail; shuffled, with -1 and past-the-end ids mixed in."""
    lengths = np.zeros(64, np.int64)
    lengths[1:9] = 1
    lengths[9] = 500
    lengths[10:40] = np.minimum(rng.geometric(0.08, 30), 200)
    lengths[40:44] = [31, 32, 33, 64]
    ids = np.repeat(np.arange(64), lengths)
    ids = np.concatenate([ids, np.full(37, -1), np.full(23, 64 + 5)])
    return rng.permutation(ids).astype(np.int32), 64


@pytest.fixture(scope="module")
def skewed():
    rng = np.random.default_rng(23)
    ids, S = _skewed_segments(rng)
    vals = (rng.standard_normal((7, ids.size)) * np.exp(rng.uniform(-4, 4, ids.size))).astype(
        np.float32)
    # cuba_tpu's Pallas kernel over chunks of 512 (ids padded with -1)
    n_pad = -(-ids.size // 512) * 512
    idp = np.concatenate([ids, np.full(n_pad - ids.size, -1, np.int32)])
    vp = np.concatenate([vals, np.zeros((7, n_pad - ids.size), np.float32)], axis=1)
    pallas = np.asarray(tpu.accum_segsum(jnp.asarray(vp), jnp.asarray(idp), S, chunk=512,
                                         interpret=True))
    ok = (ids >= 0) & (ids < S)
    bound = np.zeros((7, S))
    np.add.at(bound.T, ids[ok], np.abs(vals[:, ok].astype(np.float64)).T)
    return ids, S, vals, pallas, bound


@pytest.mark.parametrize("group", [1, 2, 4, 8, 16, 32])
def test_segsum_walk_matches_plain_and_pallas(skewed, group):
    ids, S, vals, pallas, bound = skewed
    walk = walks.segsum_walk(vals, segmm.segment_csr(ids, S, "cpu"), group)
    plain = segmm.segsum_plain(torch.from_numpy(vals), torch.from_numpy(ids), S).numpy()
    assert walk.dtype == np.float32 and walk.shape == (7, S)
    for want in (plain, pallas):
        assert np.all(np.abs(walk.astype(np.float64) - want) <= SUM_RTOL * bound)
    assert not walk[:, 0].any() and not walk[:, 50:].any()  # empty segments
    lone = np.array([vals[:, np.flatnonzero(ids == s)[0]] for s in range(1, 9)]).T
    np.testing.assert_array_equal(walk[:, 1:9], lone)  # a single term is exact


def test_segsum_walk_follows_the_lane_order():
    """Four terms whose fp32 sum depends on the order: with G = 1 the serial
    chain ((a + b) + c) + d, with G = 2 (a + c) + (b + d)."""
    a, b, c, d = np.float32(1e8), np.float32(1.0), np.float32(-1e8), np.float32(1.0)
    vals = np.array([[a, b, c, d]], np.float32)
    csr = segmm.segment_csr(np.zeros(4, np.int32), 1, "cpu")
    assert csr.group == 1  # four entries: one lane
    serial = walks.segsum_walk(vals, csr)[0, 0]
    assert serial == walks.segsum_walk(vals, csr, 1)[0, 0]
    assert serial == np.float32(np.float32(np.float32(a + b) + c) + d) == 1.0
    assert walks.segsum_walk(vals, csr, 2)[0, 0] == np.float32(
        np.float32(a + c) + np.float32(b + d)) == 2.0
    # G = 4, one term per lane: offset 2 pairs a with c and b with d, then
    # offset 1 adds the pairs
    assert walks.segsum_walk(vals, csr, 4)[0, 0] == np.float32(
        np.float32(a + c) + np.float32(b + d))


@pytest.mark.parametrize("D,N,group,rows", [
    (42, 423_004, 32, 1),  # kitti00 pose sums: 71 MB of values, scattered columns
    (36, 1_951_149, 32, 1),  # the AoS triplet sums
    (36, 564_010, 32, 1),  # the PCG preconditioner's pose sums
    (42, 141_006, 32, 4),  # 24 MB: 11 chunks of at most 4 rows
    (42, 423_004, 16, 4),  # shorter segments: 4 rows a chunk
    (6, 564_010, 32, 3),  # 14 MB: two chunks of 3
    (36, 271_462, 4, 4),
    (18, 423_004, 1, 4),  # five chunks: 4, 4, 4, 4, 2
    (12, 423_345, 1, 4),
    (3, 564_010, 2, 3),
    (1, 10, 1, 1),
    (0, 10, 1, 1),
])
def test_row_chunk_rule(D, N, group, rows):
    assert segmm.row_chunk(D, N, group) == rows
