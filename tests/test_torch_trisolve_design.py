"""The CUDA diagonal copy's, two sweeps' and matvec's design, checked on
the CPU: the launch rules, the copy's index arithmetic, the sweeps' ticket
orders and the matvec's summation order.

The kernels (``csrc/trisolve.cu`` ``extract_diag_kernel``,
``solve_lower_kernel``, ``solve_upper_kernel``, ``matvec_kernel``) cannot
run here.  The sweeps' blocks wait on each other's flags: a scheduler with
only R blocks resident shows every tile finishing with tickets, down to R =
8 (a stripe's tiles) for the backward sweep and R = 1 for the forward one
(its tiles never wait on their own stripe), and the opposite start order
stalling (their NumPy walks are held to the plain versions in
``tests/test_torch_dense.py``).  ``walks.extract_diag_walk`` is the copy's grid
arithmetic in NumPy: every output float4 written once, bit for bit the plain
version and cuba_tpu's Pallas ``_extract_diag_blocks`` in interpret mode.
``walks.matvec_walk`` is the matvec's order (slices, lanes, accumulators,
fp32 FMAs); the card's tests hold the kernel to it.  Here it is held within
1e-6 of each row's sum of |A_ij x_j| of the plain version and of cuba_tpu's
Pallas ``matvec`` in interpret mode (``tests/test_torch_dense.py``'s bar).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuba_tpu.solver import trisolve as tpu_trisolve
from cuba_tpu_torch.ops import walks
from cuba_tpu_torch.solver import trisolve

torch.set_num_threads(1)

SUM_RTOL = 1e-6


@pytest.mark.parametrize("n,slices", [(768, 8), (1536, 4), (3072, 2), (8448, 1)])
def test_matvec_slice_rule(n, slices):
    assert trisolve.matvec_slices(n) == slices
    # the rule's point fills the card to at least MATVEC_WARPS_PER_SM an SM
    # where the cap allows
    assert n * slices >= trisolve.SMS * trisolve.MATVEC_WARPS_PER_SM


@pytest.mark.parametrize("K,grid", [(2, [32, 2]), (6, [32, 6]), (8, [32, 8]), (9, [32, 9]),
                                    (33, [32, 33])])
def test_diag_launch_rule(K, grid):
    launch = trisolve.diag_launch(K)
    assert launch == dict(grid=grid, loads=trisolve.DIAG_LOADS)
    if K >= 6:  # kitti07 (K = 6) and up: at least one block per SM
        assert grid[0] * grid[1] >= trisolve.SMS


def test_fma32_rounds_once():
    """(1 + 2^-12)^2 + 2^-80 lies just above an fp32 midpoint: one rounding
    goes up, an fp64 sum rounded again to fp32 lands on the midpoint and
    goes down to even."""
    a, c = np.float32(1 + 2 ** -12), np.float32(2 ** -80)
    assert walks.fma32(a, a, c) == np.float32(1 + 2 ** -11 + 2 ** -23)
    assert np.float32(np.float64(a) * np.float64(a) + np.float64(c)) == np.float32(1 + 2 ** -11)
    rng = np.random.default_rng(3)
    x, y, z = (rng.standard_normal(1000).astype(np.float32) for _ in range(3))
    exact = x.astype(np.float64) * y + z  # exact here: no rounding to fp64 beyond 53 bits
    np.testing.assert_array_equal(walks.fma32(x, y, z), exact.astype(np.float32))


def _problem(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)).astype(np.float32)
    x = (rng.standard_normal(n) * np.exp(rng.uniform(-3, 3, n))).astype(np.float32)
    return A, x, np.abs(A).astype(np.float64) @ np.abs(x).astype(np.float64)


@pytest.mark.parametrize("n", [768, 1536])
def test_matvec_walk_matches_plain_and_pallas(n):
    A, x, bound = _problem(n, n)
    walk = walks.matvec_walk(A, x)
    assert walk.dtype == np.float32 and walk.shape == (n,)
    plain = trisolve.matvec_plain(torch.from_numpy(A), torch.from_numpy(x)).numpy()
    pallas = np.asarray(tpu_trisolve.matvec(jnp.asarray(A), jnp.asarray(x), interpret=True))
    for want in (plain, pallas):
        assert np.all(np.abs(walk.astype(np.float64) - want) <= SUM_RTOL * bound)


@pytest.mark.parametrize("n", [1, 3, 255, 1001])
def test_matvec_walk_any_n_matches_plain(n):
    """n % 4 != 0 (and n below a warp): the partial last quad and the empty
    slices."""
    A, x, bound = _problem(n, n + 17)
    walk = walks.matvec_walk(A, x)
    plain = trisolve.matvec_plain(torch.from_numpy(A), torch.from_numpy(x)).numpy()
    assert walk.shape == (n,)
    assert np.all(np.abs(walk.astype(np.float64) - plain) <= SUM_RTOL * bound)


def test_matvec_walk_follows_its_order():
    """One row whose fp32 sum depends on the order, at S = 1 (U = 4): quad 0
    (lane 0, t = 0) into acc 0, quad 32 (lane 0, t = 1) into acc 1, every
    other quad zero; the row is acc0 + acc1 and the butterfly adds zeros."""
    n = 4 * 33
    A = np.zeros((n, n), np.float32)
    A[0, 0:4] = [1e8, 1.0, -1e8, 1.0]  # serial FMAs: ((1e8 + 1) - 1e8) + 1 = 1
    A[0, 128] = 1.0
    x = np.ones(n, np.float32)
    assert walks.matvec_walk(A, x, slices=1)[0] == np.float32(2.0)
    # with S = 2, quad 32 is lane 15 of slice 1 (w = 17): the same terms
    assert walks.matvec_walk(A, x, slices=2)[0] == np.float32(2.0)
    A[0, 1] = 0.5  # 1e8 + 0.5 rounds to 1e8 in fp32: the chain loses it
    assert walks.matvec_walk(A, x, slices=1)[0] == np.float32(2.0)
    assert float(trisolve.matvec_plain(torch.from_numpy(A.astype(np.float64)),
                                       torch.from_numpy(x.astype(np.float64)))[0]) == 2.5


@pytest.mark.parametrize("K,grid", [(2, 16), (6, 48), (33, 264)])
def test_solve_upper_launch_rule(K, grid):
    """Tiles of 32 columns, one block each; a stripe's 8 tiles must be
    resident at once (far below the card's 132 SMs); every tile of every
    stripe held by exactly one ticket, stripe K-1's first."""
    launch = trisolve.solve_upper_launch(K * trisolve.BLOCK)
    assert launch == dict(tile=32, grid=[grid])
    assert trisolve.BLOCK // launch["tile"] == 8 <= trisolve.SMS
    tiles = [trisolve.solve_upper_tile(t, K) for t in range(grid)]
    assert sorted(tiles) == [(i, c) for i in range(K) for c in range(0, 256, 32)]
    assert [i for i, _c in tiles] == sorted((i for i, _c in tiles), reverse=True)


def _schedule(K, resident, tickets=True):
    """solve_upper_kernel's blocks on a card that holds ``resident`` of them
    at once, a new block starting (in blockIdx order) when one exits.  A
    block takes its tile from the ticket (``tickets``) or from its blockIdx,
    stripe 0 first; a tile of stripe i < K-1 adds one to cnt[i] once every
    ready[j > i] is full, then waits for cnt[i] to fill; it then adds one to
    ready[i] and exits (the top stripe reads y and exits at once).  Returns
    the tiles that finished before no block could move."""
    per = trisolve.BLOCK // trisolve.UPPER_TILE
    total = K * per
    cnt, ready = [0] * K, [0] * K
    running, started, done = [], 0, 0
    while True:
        while len(running) < resident and started < total:
            stripe = trisolve.solve_upper_tile(started, K)[0] if tickets else started // per
            running.append([stripe, 0])  # [stripe, stage: 0 before cnt, 1 after]
            started += 1
        moved = False
        for blk in list(running):
            i, stage = blk
            if stage == 0 and i + 1 < K and all(ready[j] == per for j in range(i + 1, K)):
                cnt[i] += 1
                blk[1] = stage = 1
                moved = True
            if (i + 1 == K and stage == 0) or (stage == 1 and cnt[i] == per):
                ready[i] += 1
                running.remove(blk)
                done += 1
                moved = True
        if not moved:
            return done


@pytest.mark.parametrize("resident", [8, trisolve.SMS])
@pytest.mark.parametrize("K", [2, 6, 33])
def test_solve_upper_tickets_never_stall(K, resident):
    """With tickets every tile finishes once a stripe's 8 blocks fit on the
    card (the least the argument needs) and on 132 SMs; handed out by
    blockIdx, stripe 0 first, the resident blocks all wait on stripes that
    have no block yet, unless the whole grid fits at once."""
    total = trisolve.solve_upper_launch(K * trisolve.BLOCK)["grid"][0]
    assert _schedule(K, resident) == total
    assert (_schedule(K, resident, tickets=False) == total) == (total <= resident)


def test_solve_upper_walk_fp32_follows_its_order():
    """The fp32 walk (the kernel's order, each FMA rounded once) lies within
    a few fp32 roundings of the plain version through six stripes (the
    card's tests hold the kernel to the walk bit for bit)."""
    n = 1536
    rng = np.random.default_rng(5)
    G = rng.standard_normal((n, n))
    L = np.linalg.cholesky(G @ G.T / n + np.eye(n)).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    invd = trisolve.prepare(torch.from_numpy(L))
    want = trisolve.solve_upper_plain(torch.from_numpy(L), invd, torch.from_numpy(y)).numpy()
    got = walks.solve_upper_walk(L, invd.numpy(), y)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("triangle", ["lower", "full"])
@pytest.mark.parametrize("n", [256, 512, 768, 1536])
def test_extract_diag_walk_matches_plain_and_pallas(n, triangle):
    """L's lower triangle (as the factor gives it) and a full matrix (every
    entry of a diagonal block non-zero)."""
    rng = np.random.default_rng(n)
    L = rng.standard_normal((n, n)).astype(np.float32)
    if triangle == "lower":
        L = np.tril(L)
    pallas = np.asarray(tpu_trisolve._extract_diag_blocks(jnp.asarray(L), trisolve.BLOCK, True))
    got, writes = walks.extract_diag_walk(L)
    assert np.all(writes == 1)  # every output float4 written exactly once
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, trisolve.extract_diag_blocks_plain(
        torch.from_numpy(L)).numpy())


@pytest.mark.parametrize("K,grid", [(2, 16), (6, 48), (33, 264)])
def test_solve_lower_launch_rule(K, grid):
    """Tiles of 32 rows, one block each; every tile of every stripe held by
    exactly one ticket, stripe 0's first."""
    launch = trisolve.solve_lower_launch(K * trisolve.BLOCK)
    assert launch == dict(tile=32, grid=[grid])
    tiles = [trisolve.solve_lower_tile(t, K) for t in range(grid)]
    assert sorted(tiles) == [(i, r) for i in range(K) for r in range(0, 256, 32)]
    assert [i for i, _r in tiles] == sorted(i for i, _r in tiles)


def _schedule_lower(K, resident, tickets=True, write="last"):
    """solve_lower_kernel's blocks on a card that holds ``resident`` of them
    at once, a new block starting when one exits.  A block takes its tile
    from the ticket (``tickets``: stripe 0 first) or, as a scheduler free to
    start blocks in any order might, stripe K-1 first.  A tile of stripe i
    adds its partial to done[i] once every done[j < i] is full.  With
    ``write="last"`` (the kernel) it then exits, the stripe's last tile
    writing y_i; with ``write="each"`` (the other design) it first waits
    for done[i] to fill and writes its own rows of y_i.  Returns the tiles
    that finished before no block could move."""
    per = trisolve.BLOCK // trisolve.LOWER_TILE
    total = K * per
    done = [0] * K
    running, started, finished = [], 0, 0
    while True:
        while len(running) < resident and started < total:
            stripe = (trisolve.solve_lower_tile(started, K)[0] if tickets
                      else K - 1 - started // per)
            running.append([stripe, 0])  # [stripe, stage: 0 before its partial, 1 after]
            started += 1
        moved = False
        for blk in list(running):
            i, stage = blk
            if stage == 0 and all(done[j] == per for j in range(i)):
                done[i] += 1
                blk[1] = stage = 1
                moved = True
            if stage == 1 and (write == "last" or done[i] == per):
                running.remove(blk)
                finished += 1
                moved = True
        if not moved:
            return finished


@pytest.mark.parametrize("resident", [1, 7, 8, trisolve.SMS])
@pytest.mark.parametrize("K", [2, 6, 33])
def test_solve_lower_tickets_never_stall(K, resident):
    """With tickets the kernel's design (the last tile of a stripe writes
    y_i) finishes with any number of resident blocks, down to one; the
    other (each tile waits for its stripe, then writes its rows) once a
    stripe's 8 blocks fit.  Started stripe K-1 first, the resident blocks
    all wait on stripes that have no block yet, unless the whole grid
    fits at once."""
    total = trisolve.solve_lower_launch(K * trisolve.BLOCK)["grid"][0]
    assert _schedule_lower(K, resident) == total
    assert (_schedule_lower(K, resident, write="each") == total) == (resident >= 8)
    assert (_schedule_lower(K, resident, tickets=False) == total) == (total <= resident)


def test_solve_lower_walk_fp32_follows_its_order():
    """The fp32 walk (the kernel's order, each FMA rounded once) lies within
    1e-5 of max |y| of the plain version through six stripes (the card's
    tests hold the kernel to the walk bit for bit)."""
    n = 1536
    rng = np.random.default_rng(6)
    G = rng.standard_normal((n, n))
    L = np.linalg.cholesky(G @ G.T / n + np.eye(n)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    invd = trisolve.prepare(torch.from_numpy(L))
    want = trisolve.solve_lower_plain(torch.from_numpy(L), invd, torch.from_numpy(b)).numpy()
    got = walks.solve_lower_walk(L, invd.numpy(), b)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_solve_lower_walk_follows_its_order():
    """Two stripes whose fp32 sums depend on the order: row 256 (tile 0 of
    stripe 1) gets 1e8 from lane 0 and -1e8 from lane 32 (the second warp)
    and 1 from lane 1; the first warp's butterfly rounds 1e8 + 1 to 1e8,
    so the row sum is 1e8 - 1e8 = 0 (exact: 1)."""
    n = 512
    L = np.eye(n, dtype=np.float32)
    b = np.zeros(n, np.float32)
    b[:256] = 1.0  # y_0 = 1 (invd[0] = I)
    L[256, 0] = 1e8   # lane 0, first warp
    L[256, 4] = 1.0   # lane 1, first warp
    L[256, 128] = -1e8  # lane 32, second warp
    invd = trisolve.prepare(torch.from_numpy(L)).numpy()
    y = walks.solve_lower_walk(L, invd, b)
    assert y[256] == np.float32(0.0)  # b - (1e8 + -1e8)
    y64 = walks.solve_lower_walk(L.astype(np.float64), invd.astype(np.float64),
                                 b.astype(np.float64))
    assert y64[256] == -1.0  # 1e8 + 1 - 1e8 held exactly in fp64
