"""cuba_tpu_torch.ops.segmm's six wrappers against cuba_tpu's Pallas kernels.

On the CPU each wrapper runs its plain torch version.  fp32: the same
inputs, made with numpy from a seed, go through cuba_tpu's kernel in
interpret mode (with a real plan from ``segmm.plan_*``) and through the
port.  Gathers must agree bit for bit (the kernels' bf16x3 split is exact);
segment sums within 1e-5 of each output's sum of |vals| (the one-hot matmul
sums in another order).  fp64: the port against the ``_xla`` twins, within
1e-12 of the same bound.  Ids include -1, ids past the end and empty
segments.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuba_tpu.ops import segmm as tpu
from cuba_tpu_torch.ops import segmm

torch.set_num_threads(1)

GATHERS = ("resident_gather", "windowed_gather", "tiled_gather")
SEGSUMS = ("accum_segsum", "accum_segsum_windowed", "tiled_segsum")


def _ids(rng, n, num, *, banded=False, sort=False):
    """ids in [0, num) with ~8% -1 and ~4% past the end; no id in the
    middle fifth of [0, num), so those segments are empty."""
    if banded:
        ids = np.clip(np.arange(n) * num // n + rng.integers(-40, 40, n), 0, num - 1)
    else:
        ids = rng.integers(0, num, n)
    gap = (ids >= 2 * num // 5) & (ids < 3 * num // 5)
    ids = np.where(gap, 2 * num // 5 - 1, ids)
    if sort:
        ids = np.sort(ids)
    u = rng.random(n)
    ids = np.where(u < 0.08, -1, np.where(u > 0.96, num + 7, ids))
    return ids.astype(np.int32)


def _gather_case(name, rng, D=12):
    """(tpu_call, port_call, xla_call) over one seeded input."""
    if name == "resident_gather":
        S, N = 384, 2048
        src = rng.standard_normal((D, S))
        ids = _ids(rng, N, S)
        return (
            lambda s: tpu.resident_gather(s, jnp.asarray(ids), interpret=True),
            lambda s: segmm.resident_gather(s, torch.from_numpy(ids)),
            lambda s: tpu.resident_gather_xla(s, jnp.asarray(ids)),
            src,
        )
    if name == "windowed_gather":
        S, N = 1280, 4096
        ids = _ids(rng, N, S, banded=True)
        # ids in [S, source width) read a window-dependent column on the TPU:
        # "past the end" here means past the source
        ids = np.where(ids == S + 7, -1, ids)
        ids[::97] = 10 ** 6
        plan = tpu.plan_accum_windows(ids, S, max_win=1024)
        assert plan.ok
        src = rng.standard_normal((D, max(plan.out_pad, S)))
        return (
            lambda s: tpu.windowed_gather(s, jnp.asarray(ids), plan, jnp.asarray(plan.wb),
                                          interpret=True),
            lambda s: segmm.windowed_gather(s, torch.from_numpy(ids), plan, plan.wb),
            lambda s: tpu.resident_gather_xla(s, jnp.asarray(ids)),
            src,
        )
    S, N = 3000, 4096
    ids = _ids(rng, N, S, sort=True)
    ids = np.where(ids == S + 7, -1, ids)  # the plan's windows only cover [0, S)
    ids[-300:] = np.int32(S + 5000)  # past the end of the padded source too
    plan = tpu.plan_gather_tiles(ids, S, tile=512, block=1024, max_blocks=8)
    assert plan.ok
    src = np.zeros((D, plan.n_pad))
    src[:, :S] = rng.standard_normal((D, S))
    idp = np.concatenate([ids, np.full(plan.num_tiles * plan.tile - N, -1, np.int32)])
    return (
        lambda s: tpu.tiled_gather(s, jnp.asarray(idp), plan, jnp.asarray(plan.base_block),
                                   num_out=N, interpret=True),
        lambda s: segmm.tiled_gather(s, torch.from_numpy(idp), plan, plan.base_block,
                                     num_out=N),
        lambda s: tpu.tiled_gather_xla(s, jnp.asarray(idp), num_out=N),
        src,
    )


def _segsum_case(name, rng, D=7):
    """(tpu_call, port_call, ids, num_out, vals)."""
    if name == "accum_segsum":
        S, N = 300, 2048
        ids = _ids(rng, N, S)
        vals = rng.standard_normal((D, N))
        return (
            lambda v: tpu.accum_segsum(v, jnp.asarray(ids), S, chunk=512, interpret=True),
            lambda v: segmm.accum_segsum(v, torch.from_numpy(ids), S, chunk=512),
            ids, S, vals,
        )
    if name == "accum_segsum_windowed":
        S, N = 1000, 4096
        ids = _ids(rng, N, S, banded=True)
        plan = tpu.plan_accum_windows(ids, S)
        assert plan.ok
        vals = rng.standard_normal((D, N))
        return (
            lambda v: tpu.accum_segsum_windowed(v, jnp.asarray(ids), S, plan,
                                                jnp.asarray(plan.wb), interpret=True),
            lambda v: segmm.accum_segsum_windowed(v, torch.from_numpy(ids), S, plan, plan.wb),
            ids, S, vals,
        )
    S, N = 1000, 4096
    ids = _ids(rng, N, S, sort=True)
    plan = tpu.plan_tiles(ids, S, tile=256, block=512, max_blocks=8)
    assert plan.ok
    n_pad = max(plan.n_pad, N)
    idp = np.concatenate([ids, np.full(n_pad - N, -1, np.int32)])
    vals = rng.standard_normal((D, n_pad))
    return (
        lambda v: tpu.tiled_segsum(v, jnp.asarray(idp), S, plan, jnp.asarray(plan.base_block),
                                   interpret=True),
        lambda v: segmm.tiled_segsum(v, torch.from_numpy(idp), S, plan, plan.base_block),
        idp, S, vals,
    )


def _abs_bound(vals, ids, num_out):
    """Per-output sum of |vals| over the segment."""
    ok = (ids >= 0) & (ids < num_out)
    out = np.zeros((vals.shape[0], num_out))
    np.add.at(out.T, ids[ok], np.abs(vals[:, ok]).T)
    return out


@pytest.mark.parametrize("name", GATHERS)
def test_gather_matches_pallas_fp32(name):
    rng = np.random.default_rng(11)
    tpu_call, port_call, _xla, src = _gather_case(name, rng)
    src32 = src.astype(np.float32)
    want = np.asarray(tpu_call(jnp.asarray(src32)))
    got = port_call(torch.from_numpy(src32))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", GATHERS)
def test_gather_matches_xla_fp64(name):
    rng = np.random.default_rng(12)
    _tpu, port_call, xla_call, src = _gather_case(name, rng)
    want = np.asarray(xla_call(jnp.asarray(src)))
    got = port_call(torch.from_numpy(src))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", SEGSUMS)
def test_segsum_matches_pallas_fp32(name):
    rng = np.random.default_rng(13)
    tpu_call, port_call, ids, S, vals = _segsum_case(name, rng)
    v32 = vals.astype(np.float32)
    want = np.asarray(tpu_call(jnp.asarray(v32)))
    got = port_call(torch.from_numpy(v32)).numpy()
    assert got.shape == want.shape == (vals.shape[0], S)
    bound = _abs_bound(v32.astype(np.float64), ids, S)
    assert np.all(np.abs(got.astype(np.float64) - want) <= 1e-5 * bound)
    assert np.all(got[:, 2 * S // 5 + 1:3 * S // 5 - 1] == 0.0)  # empty segments


@pytest.mark.parametrize("name", SEGSUMS)
def test_segsum_matches_xla_fp64(name):
    rng = np.random.default_rng(14)
    _tpu, port_call, ids, S, vals = _segsum_case(name, rng)
    want = np.asarray(tpu.accum_segsum_xla(jnp.asarray(vals), jnp.asarray(ids), S))
    got = port_call(torch.from_numpy(vals)).numpy()
    assert np.all(np.abs(got - want) <= 1e-12 * _abs_bound(vals, ids, S))


def test_segment_csr_orders_valid_ids_stably():
    ids = np.array([3, -1, 0, 3, 9, 0, 2, 3], np.int32)
    csr = segmm.segment_csr(ids, 5, "cpu")
    np.testing.assert_array_equal(csr.order.numpy(), [2, 5, 6, 0, 3, 7])
    np.testing.assert_array_equal(csr.offs.numpy(), [0, 2, 2, 3, 6, 6])
    assert csr.order.dtype == csr.offs.dtype == torch.int32


def test_use_plain_restores_dispatch():
    assert not segmm._FORCE_PLAIN[0]
    with segmm.use_plain():
        assert segmm._FORCE_PLAIN[0]
    assert not segmm._FORCE_PLAIN[0]
