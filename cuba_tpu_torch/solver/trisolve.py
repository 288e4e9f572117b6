"""Blocked triangular solves for the dense reduced system (port of
``cuba_tpu/solver/trisolve.py``).

The lower Cholesky factor L [n, n] of the reduced system is swept in K =
n / B stripes (B = 256): the diagonal blocks are inverted once per
factorisation (:func:`prepare`), and each sweep is then one product with an
inverted diagonal block and one stripe update per step, with the running
update ``d`` carried from step to step.  ``matvec`` is the refinement
residual's fp32-exact A x.

=========================  ==========================================
this module                ``cuba_tpu/solver/trisolve.py``
=========================  ==========================================
``extract_diag_blocks``    ``_extract_diag_blocks`` (74), kernel 11
``tri_inv_blocks``         ``tri_inv_blocks`` (51; XLA there, torch here)
``prepare``                ``prepare`` (94)
``solve_lower``            ``solve_lower`` (120), kernel 12
``solve_upper``            ``solve_upper`` (159), kernel 13
``matvec``                 ``matvec`` (200), kernel 14
``usable``                 ``usable`` (228)
=========================  ==========================================

Each kernel wrapper has a ``*_plain`` twin, the blocked algorithm itself in
torch (``torch.matmul`` on stripes, ``A @ x``), taken for CPU tensors and
under ``cudalib.use_plain()``; a CUDA tensor launches the hand-written
kernel of ``csrc/trisolve.cu`` (one host call per sweep: 2K launches for
``solve_lower``, one for ``solve_upper``).  The port's sweeps run in exact
fp32, where the TPU's ran their stripe updates at the MXU's default
bf16-pass precision.

The launches of the diagonal copy (:func:`diag_launch`), the backward sweep
(:func:`solve_upper_launch`) and the matvec (:func:`matvec_launch`, with its
one rule, :func:`matvec_slices`) live here, with their kernels' index
arithmetic and summation order in NumPy (:func:`extract_diag_walk`,
:func:`solve_upper_walk`, :func:`matvec_walk`) for the tests.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cuba_tpu_torch.ops import cudalib
from cuba_tpu_torch.ops.cudalib import LAUNCHES

BLOCK = 256  # stripe width; n (= 6 * pad_blocks) is a multiple of 768
SMS = 132  # the H100's streaming multiprocessors
THREADS = 256  # threads a block of the diagonal copy, the backward sweep and the matvec
QUADS = BLOCK // 4  # float4 per row of a diagonal block
DIAG_PASS = THREADS // QUADS  # rows of a diagonal block one load of a block covers
DIAG_LOADS = 2  # float4 a thread of the copy moves (kLoads in csrc/trisolve.cu)
MATVEC_WARPS_PER_SM = 32  # the matvec's slices fill the card to this many warps an SM
MAX_SLICES = 8  # a block's 8 warps
MATVEC_ACCS = 4  # accumulators a lane, U (kAccs in csrc/trisolve.cu)
UPPER_TILE = 32  # columns of one stripe a block of solve_upper_kernel takes (kTile)

KERNEL_SRC = cudalib.SOURCES["trisolve"]
_i32, _i64, _vp = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
_SIGNATURES = {
    "cuba_extract_diag_blocks": [_vp, _i64, _vp, _vp],
    "cuba_solve_lower": [_vp, _vp, _vp, _vp, _vp, _i64, _i64, _vp],
    "cuba_solve_upper": [_vp, _vp, _vp, _vp, _vp, _i64, _vp],
    "cuba_solve_upper_work": [_i64],
    "cuba_matvec": [_vp, _vp, _vp, _i64, _i32, _i32, _vp],
}


def _lib() -> ctypes.CDLL:
    return cudalib.library("trisolve", _SIGNATURES)


def _stripes(L: torch.Tensor, block: int) -> int:
    """K, the stripe count of a square [n, n] L with n a multiple of block."""
    n = L.shape[0]
    if L.dim() != 2 or L.shape[1] != n or n % block != 0:
        raise ValueError(f"expected a square matrix of a multiple of {block} rows, "
                         f"got {tuple(L.shape)}")
    return n // block


def _check_sweep(L, invd, v, block):
    K = _stripes(L, block)
    if tuple(invd.shape) != (K, block, block) or tuple(v.shape) != (L.shape[0],):
        raise ValueError(f"invd {tuple(invd.shape)} / vector {tuple(v.shape)} do not fit "
                         f"L {tuple(L.shape)} in stripes of {block}")
    if not cudalib.use_kernel(L, invd, v):
        return False
    for t, name in ((L, "L"), (invd, "invd"), (v, "vector")):
        cudalib.check(t, name, torch.float32, t.dim())
    return True


def extract_diag_blocks_plain(L, block: int = BLOCK):
    K = _stripes(L, block)
    return torch.diagonal(L.reshape(K, block, K, block), dim1=0, dim2=2).permute(2, 0, 1) \
        .contiguous()


def diag_launch(K: int) -> dict:
    """The diagonal copy's launch for K blocks of 256: ``loads`` float4 a
    thread (each thread issues both before its first store) and the
    ``grid`` [row groups, K] of THREADS-thread blocks: 192 blocks at
    kitti07's K = 6, at least one per SM."""
    return dict(grid=[BLOCK // (DIAG_PASS * DIAG_LOADS), K], loads=DIAG_LOADS)


def extract_diag_walk(L: np.ndarray):
    """The diagonal copy's index arithmetic in NumPy (for tests): block (x,
    k) of the grid, thread t and load i < DIAG_LOADS copy float4 number
    r * n/4 + k * QUADS + t % QUADS of L to number r * QUADS + t % QUADS of
    the output, r = k * BLOCK + x * DIAG_PASS * DIAG_LOADS + t // QUADS + i
    * DIAG_PASS.  Returns ([K, B, B], the times each output float4 was
    written)."""
    n = L.shape[0]
    K = n // BLOCK
    gx = diag_launch(K)["grid"][0]
    k, x, t, i = np.meshgrid(np.arange(K), np.arange(gx), np.arange(THREADS),
                             np.arange(DIAG_LOADS), indexing="ij")
    c = t % QUADS
    r = k * BLOCK + x * (DIAG_PASS * DIAG_LOADS) + t // QUADS + i * DIAG_PASS
    src, dst = (r * (n // 4) + k * QUADS + c).ravel(), (r * QUADS + c).ravel()
    out = np.zeros((K * BLOCK * QUADS, 4), L.dtype)
    out[dst] = np.asarray(L).reshape(-1, 4)[src]
    return out.reshape(K, BLOCK, BLOCK), np.bincount(dst, minlength=out.shape[0])


def extract_diag_blocks(L, block: int = BLOCK):
    """[K, B, B] copy of L's diagonal B x B blocks.  On the card: B = 256
    and L 16-byte aligned (the kernel's float4 loads), else it raises."""
    K = _stripes(L, block)
    if not cudalib.use_kernel(L):
        return extract_diag_blocks_plain(L, block)
    cudalib.check(L, "L", torch.float32, 2)
    if block != BLOCK:
        raise ValueError(f"extract_diag_blocks: the kernel copies blocks of {BLOCK}, not {block}")
    if L.data_ptr() % 16:
        raise ValueError("extract_diag_blocks: L must be 16-byte aligned (float4 loads)")
    cudalib.check_int32("extract_diag_blocks", L.numel())
    out = torch.empty((K, BLOCK, BLOCK), dtype=torch.float32, device=L.device)
    cudalib.call("extract_diag_blocks", L, _lib().cuba_extract_diag_blocks,
                 L.data_ptr(), L.shape[0], out.data_ptr())
    LAUNCHES["extract_diag_blocks"] += 1
    return out


def tri_inv_blocks(Ld: torch.Tensor) -> torch.Tensor:
    """Batched inverse of lower-triangular blocks [batch, m, m]: one batched
    triangular solve against I.  ``cuba_tpu`` unrolls a 16-wide recursion
    in XLA; as torch ops that would be hundreds of tiny launches.  torch
    returns the blocks column-major; the sweep kernels read them row-major."""
    eye = torch.eye(Ld.shape[-1], dtype=Ld.dtype, device=Ld.device).expand_as(Ld)
    return torch.linalg.solve_triangular(Ld, eye, upper=False).contiguous()


def prepare(L, block: int = BLOCK):
    """Inverted diagonal blocks [K, B, B] for solve_lower / solve_upper."""
    return tri_inv_blocks(extract_diag_blocks(L, block))


def solve_lower_plain(L, invd, b, block: int = BLOCK):
    K = _stripes(L, block)
    d = torch.zeros_like(b)
    y = torch.empty_like(b)
    for k in range(K):
        lo, hi = k * block, (k + 1) * block
        y[lo:hi] = invd[k] @ (b[lo:hi] + d[lo:hi])
        d[hi:] -= L[hi:, lo:hi] @ y[lo:hi]
    return y


def solve_lower(L, invd, b, block: int = BLOCK):
    """y = L^-1 b for lower-triangular L [n, n], b [n], right-looking over
    column stripes: y_k = invd[k] (b_k + d_k), then d -= L[:, k] y_k below
    the diagonal block."""
    if not _check_sweep(L, invd, b, block):
        return solve_lower_plain(L, invd, b, block)
    n = L.shape[0]
    y = torch.empty_like(b)
    d = torch.zeros_like(b)
    cudalib.call("solve_lower", L, _lib().cuba_solve_lower, L.data_ptr(), invd.data_ptr(),
                 b.data_ptr(), y.data_ptr(), d.data_ptr(), n, block)
    LAUNCHES["solve_lower"] += 1
    return y


def solve_upper_plain(L, invd, y, block: int = BLOCK):
    K = _stripes(L, block)
    d = torch.zeros_like(y)
    x = torch.empty_like(y)
    for k in reversed(range(K)):
        lo, hi = k * block, (k + 1) * block
        x[lo:hi] = invd[k].T @ (y[lo:hi] + d[lo:hi])
        d[:lo] -= L[lo:hi, :lo].T @ x[lo:hi]
    return x


def solve_upper(L, invd, y, block: int = BLOCK):
    """x = L^-T y, backward over ROW stripes of L (no transpose is formed).
    The plain version: x_k = invd[k]^T (y_k + d_k), then d -= L[k, :]^T x_k
    left of the diagonal block.  On the card: one launch of
    ``solve_upper_kernel`` (:func:`solve_upper_launch`,
    :func:`solve_upper_walk`) after one zeroing of its workspace; B = 256,
    and L and invd 16-byte aligned, else it raises."""
    if not _check_sweep(L, invd, y, block):
        return solve_upper_plain(L, invd, y, block)
    if block != BLOCK:
        raise ValueError(f"solve_upper: the kernel walks stripes of {BLOCK}, not {block}")
    if L.data_ptr() % 16 or invd.data_ptr() % 16:
        raise ValueError("solve_upper: L and invd must be 16-byte aligned (float4 loads)")
    cudalib.check_int32("solve_upper", L.numel())
    n = L.shape[0]
    x = torch.empty_like(y)
    lib = _lib()
    work = torch.zeros(lib.cuba_solve_upper_work(n), dtype=torch.int32, device=L.device)
    cudalib.call("solve_upper", L, lib.cuba_solve_upper, L.data_ptr(), invd.data_ptr(),
                 y.data_ptr(), x.data_ptr(), work.data_ptr(), n)
    LAUNCHES["solve_upper"] += 1
    return x


def solve_upper_launch(n: int) -> dict:
    """``solve_upper_kernel``'s launch for n = K * 256: the ``tile`` width T
    (columns of one stripe a block takes) and the ``grid`` of K * 256/T
    blocks, one ticket each (stripe K-1's tiles first, then K-2's, ...:
    :func:`solve_upper_tile`).  Every wait ends once a stripe's 256/T
    blocks can be resident at once."""
    return dict(tile=UPPER_TILE, grid=[n // BLOCK * (BLOCK // UPPER_TILE)])


def solve_upper_tile(ticket: int, K: int):
    """(stripe, first column in the stripe) of ``ticket``: stripe K-1's
    256/T tiles hold tickets 0 .. 256/T - 1, stripe K-2's the next, ..."""
    per = BLOCK // UPPER_TILE
    return K - 1 - ticket // per, ticket % per * UPPER_TILE


def solve_upper_walk(L, invd, y) -> np.ndarray:
    """``solve_upper_kernel``'s order in NumPy (for tests), over flat memory
    as the kernel addresses it.  Tiles in ticket order; a tile of stripe i
    and T = UPPER_TILE columns is THREADS threads, thread (g, q) taking
    column quad q < T/4 and rows g + G*m (m < R) of a stripe, G = THREADS /
    (T/4) groups, R = 256 / G.  It adds L[row, c] x[row] into its
    accumulator for stripes j = K-1 down to i+1, its rows in order; the
    groups' sums are added in group order and r = y - that sum goes to
    rbuf.  Once every tile of the stripe has written rbuf (``cnt``), each
    reads r_i and takes its T entries of x_i = invd[i]^T r_i in the same
    shape over invd[i]'s rows.  The top stripe reads r = y.  fp32 input is
    walked with :func:`fma32` (each FMA rounded once: the card's bits), fp64
    with fp64 FMAs."""
    L, invd, y = np.asarray(L), np.asarray(invd), np.asarray(y)
    dt = L.dtype
    fma = fma32 if dt == np.float32 else (lambda a, b, c: a * b + c)
    n = L.shape[0]
    K = n // BLOCK
    T = UPPER_TILE
    G = THREADS // (T // 4)
    R = BLOCK // G
    Lf, invf = L.reshape(-1), invd.reshape(-1)
    x, rbuf = np.zeros(n, dt), np.zeros(n, dt)
    g, c = np.arange(G)[:, None], np.arange(T)[None, :]  # row group, tile column

    def combine(acc):
        s = acc[0]
        for h in range(1, G):
            s = s + acc[h]
        return s

    per = BLOCK // T
    for first in range(0, K * per, per):  # a stripe's tickets
        tiles = [solve_upper_tile(t, K) for t in range(first, first + per)]
        i = tiles[0][0]
        for _i, col in tiles:  # up to the cnt wait
            c0 = i * BLOCK + col
            if i + 1 < K:
                acc = np.zeros((G, T), dt)
                for j in range(K - 1, i, -1):
                    for m in range(R):
                        rows = j * BLOCK + g + G * m
                        acc = fma(Lf[rows * n + c0 + c], x[rows], acc)
                rbuf[c0 + c[0]] = y[c0 + c[0]] - combine(acc)
        r = rbuf[i * BLOCK:(i + 1) * BLOCK] if i + 1 < K else y[i * BLOCK:(i + 1) * BLOCK]
        for _i, col in tiles:  # the diagonal step, from rbuf
            acc = np.zeros((G, T), dt)
            for m in range(R):
                a = g + G * m
                acc = fma(invf[i * BLOCK * BLOCK + a * BLOCK + col + c], r[a], acc)
            x[i * BLOCK + col + c[0]] = combine(acc)
    return x


def matvec_plain(A, x, block: int = BLOCK):
    return A @ x


def matvec_slices(n: int) -> int:
    """S, the slices (one warp each) a row of the matvec is cut into: the
    smallest power of two with n * S warps at or above MATVEC_WARPS_PER_SM
    an SM, at most MAX_SLICES.  It fixes the summation order
    (:func:`matvec_walk`)."""
    S = 1
    while n * S < SMS * MATVEC_WARPS_PER_SM and S < MAX_SLICES:
        S *= 2
    return S


def matvec_launch(A, x) -> dict:
    """The matvec's launch: ``slices`` S, ``accs`` U, and ``float4`` where
    n % 4 == 0 and A and x are 16-byte aligned (four scalar loads a quad
    otherwise, in the same order)."""
    return dict(slices=matvec_slices(A.shape[0]), accs=MATVEC_ACCS, float4=_float4(A, x))


def _float4(A, x) -> bool:
    return A.shape[0] % 4 == 0 and A.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0


def fma32(a, b, c):
    """fp32 fused multiply-add rounded once, as the card's ``fmaf``: the
    product of two fp32 values is exact in fp64; the fp64 sum is rounded to
    odd (its error from TwoSum), which an fp32 rounding then takes to the
    correctly rounded result."""
    p = np.asarray(a, np.float32).astype(np.float64) * np.asarray(b, np.float32)
    c = np.asarray(c, np.float32).astype(np.float64)
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((err != 0) & even, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def matvec_walk(A, x, slices: int = None) -> np.ndarray:
    """The CUDA matvec's exact fp32 summation order, in NumPy (for tests).
    A row's n columns form q = ceil(n/4) quads (a partial last one padded
    with zero terms), cut into ``slices`` S (by default :func:`matvec_slices`)
    of w = ceil(q/S) quads.  Lane l < 32 of slice s adds quads s*w + l + 32t,
    t = 0, 1, ..., below min(q, (s+1)*w), into accumulator t % MATVEC_ACCS,
    the quad's four terms by :func:`fma32` in column order, from 0; its
    partial is acc[0] + acc[1] + ... in index order; for o = 16, ..., 1
    every lane adds lane (l xor o)'s partial; the row's sum is the slices'
    partials added in slice order.  Returns [n] fp32."""
    A, x = np.asarray(A, np.float32), np.asarray(x, np.float32)
    n = A.shape[0]
    S = matvec_slices(n) if slices is None else slices
    q = -(-n // 4)
    w = -(-q // S)
    Ap = np.zeros((n, 4 * q), np.float32)
    Ap[:, :n] = A
    xp = np.zeros(4 * q, np.float32)
    xp[:n] = x
    lanes = np.arange(32)
    parts = []
    for s in range(S):
        lo, hi = s * w, min(q, (s + 1) * w)
        acc = np.zeros((MATVEC_ACCS, n, 32), np.float32)
        for t in range(-(-max(hi - lo, 0) // 32)):
            j = lo + 32 * t + lanes
            live = j < hi
            j = np.where(live, j, 0)
            for c in range(4):
                acc[t % MATVEC_ACCS] = np.where(live, fma32(Ap[:, 4 * j + c], xp[4 * j + c],
                                                     acc[t % MATVEC_ACCS]), acc[t % MATVEC_ACCS])
        p = acc[0]
        for u in range(1, MATVEC_ACCS):
            p = p + acc[u]
        o = 16
        while o:
            p = p + p[:, lanes ^ o]
            o //= 2
        parts.append(p[:, 0])
    y = parts[0]
    for p in parts[1:]:
        y = y + p
    return y


def matvec(A, x, block: int = BLOCK):
    """y = A x in exact fp32, one fixed summation order per row
    (:func:`matvec_walk`; the iterative-refinement residual)."""
    n = A.shape[0]
    if A.dim() != 2 or A.shape[1] != n or tuple(x.shape) != (n,):
        raise ValueError(f"A {tuple(A.shape)} and x {tuple(x.shape)} do not fit")
    if not cudalib.use_kernel(A, x):
        return matvec_plain(A, x, block)
    cudalib.check(A, "A", torch.float32, 2)
    cudalib.check(x, "x", torch.float32, 1)
    cudalib.check_int32("matvec", A.numel())
    if n == 0:
        return torch.empty_like(x)
    y = _matvec_kernel(A, x, matvec_slices(n))
    LAUNCHES["matvec"] += 1
    return y


def _matvec_kernel(A, x, slices: int):
    """The matvec's kernel at ``slices`` S (the wrapper passes the rule's;
    the probe and the card's tests sweep it)."""
    y = torch.empty_like(x)
    cudalib.call("matvec", A, _lib().cuba_matvec, A.data_ptr(), x.data_ptr(), y.data_ptr(),
                 A.shape[0], slices, int(_float4(A, x)))
    return y


def usable(n: int, dtype, block: int = BLOCK) -> bool:
    """The blocked sweeps' gate: fp32, the stripe divides n, at least two
    stripes.  (``cuba_tpu`` also caps the stripe's VMEM footprint; that
    limit is the TPU's, and the kernels here stream L from device memory.)"""
    return dtype == torch.float32 and n % block == 0 and n >= 2 * block
