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
kernel of ``csrc/trisolve.cu`` (one launch per sweep).  The port's sweeps
run in exact fp32, where the TPU's ran their stripe updates at the MXU's
default bf16-pass precision.

The launches of the diagonal copy (:func:`diag_launch`), the two sweeps
(:func:`solve_lower_launch`, :func:`solve_upper_launch`) and the matvec
(:func:`matvec_launch`, with its one rule, :func:`matvec_slices`) live
here; their kernels' index arithmetic and summation order in NumPy are
``ops/walks.py``'s (``extract_diag_walk``, ``solve_lower_walk``,
``solve_upper_walk``, ``matvec_walk``).
"""

from __future__ import annotations

import ctypes

import torch

from cuba_tpu_torch import trace
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
LOWER_TILE = 32  # rows of one stripe a block of solve_lower_kernel takes (kTile)

KERNEL_SRC = cudalib.SOURCES["trisolve"]
_i32, _i64, _vp = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
_SIGNATURES = {
    "cuba_extract_diag_blocks": [_vp, _i64, _vp, _vp],
    "cuba_solve_lower": [_vp, _vp, _vp, _vp, _vp, _i64, _vp],
    "cuba_solve_lower_work": [_i64],
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


def extract_diag_blocks(L, block: int = BLOCK):
    """[K, B, B] copy of L's diagonal B x B blocks.  On the card: B = 256
    and L 16-byte aligned (the kernel's float4 loads), else it raises."""
    with trace.span("k.extract_diag"):
        K = _stripes(L, block)
        if not cudalib.use_kernel(L):
            return extract_diag_blocks_plain(L, block)
        cudalib.check(L, "L", torch.float32, 2)
        if block != BLOCK:
            raise ValueError(f"extract_diag_blocks: the kernel copies blocks of {BLOCK}, "
                             f"not {block}")
        if L.data_ptr() % 16:
            raise ValueError("extract_diag_blocks: L must be 16-byte aligned (float4 loads)")
        # int64 offsets of L's rows; the copy's own indices (n * 64 float4) int32
        cudalib.check_int32("extract_diag_blocks", K * BLOCK * BLOCK)
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
    """y = L^-1 b for lower-triangular L [n, n], b [n].  The plain version
    is right-looking over column stripes: y_k = invd[k] (b_k + d_k), then
    d -= L[:, k] y_k below the diagonal block.  On the card: one launch of
    ``solve_lower_kernel`` (:func:`solve_lower_launch`,
    ``walks.solve_lower_walk``), left-looking over row stripes, after one
    zeroing of its workspace; B = 256, and L and invd 16-byte aligned,
    else it raises."""
    with trace.span("k.solve_lower"):
        if not _check_sweep(L, invd, b, block):
            return solve_lower_plain(L, invd, b, block)
        return _sweep_kernel("solve_lower", L, invd, b, block)


def _sweep_kernel(name, L, invd, v, block):
    """One launch of the sweep ``name`` (``solve_lower`` or
    ``solve_upper``) on a zeroed workspace of the kernel's size."""
    if block != BLOCK:
        raise ValueError(f"{name}: the kernel walks stripes of {BLOCK}, not {block}")
    if L.data_ptr() % 16 or invd.data_ptr() % 16:
        raise ValueError(f"{name}: L and invd must be 16-byte aligned (float4 loads)")
    n = L.shape[0]
    # int64 offsets of L's rows; the workspace's words (< 16 n) int32
    cudalib.check_int32(name, 16 * n)
    out = torch.empty_like(v)
    lib = _lib()
    work = torch.zeros(getattr(lib, f"cuba_{name}_work")(n), dtype=torch.int32,
                       device=L.device)
    cudalib.call(name, L, getattr(lib, f"cuba_{name}"), L.data_ptr(), invd.data_ptr(),
                 v.data_ptr(), out.data_ptr(), work.data_ptr(), n)
    LAUNCHES[name] += 1
    return out


def solve_lower_launch(n: int) -> dict:
    """``solve_lower_kernel``'s launch for n = K * 256: the ``tile`` height
    T (rows of one stripe a block takes) and the ``grid`` of K * 256/T
    blocks, one ticket each (stripe 0's tiles first, then 1's, ...:
    :func:`solve_lower_tile`).  A tile waits only on lower stripes, so
    every wait ends once one block can be resident."""
    return dict(tile=LOWER_TILE, grid=[n // BLOCK * (BLOCK // LOWER_TILE)])


def solve_lower_tile(ticket: int, K: int):
    """(stripe, first row in the stripe) of ``ticket``: stripe 0's 256/T
    tiles hold tickets 0 .. 256/T - 1, stripe 1's the next, ..."""
    per = BLOCK // LOWER_TILE
    return ticket // per, ticket % per * LOWER_TILE


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
    ``walks.solve_upper_walk``) after one zeroing of its workspace; B = 256,
    and L and invd 16-byte aligned, else it raises."""
    with trace.span("k.solve_upper"):
        if not _check_sweep(L, invd, y, block):
            return solve_upper_plain(L, invd, y, block)
        return _sweep_kernel("solve_upper", L, invd, y, block)


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


def matvec_plain(A, x, block: int = BLOCK):
    return A @ x


def matvec_slices(n: int) -> int:
    """S, the slices (one warp each) a row of the matvec is cut into: the
    smallest power of two with n * S warps at or above MATVEC_WARPS_PER_SM
    an SM, at most MAX_SLICES.  It fixes the summation order
    (``walks.matvec_walk``)."""
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


def matvec(A, x, block: int = BLOCK):
    """y = A x in exact fp32, one fixed summation order per row
    (``walks.matvec_walk``; the iterative-refinement residual)."""
    with trace.span("k.matvec"):
        n = A.shape[0]
        if A.dim() != 2 or A.shape[1] != n or tuple(x.shape) != (n,):
            raise ValueError(f"A {tuple(A.shape)} and x {tuple(x.shape)} do not fit")
        if not cudalib.use_kernel(A, x):
            return matvec_plain(A, x, block)
        cudalib.check(A, "A", torch.float32, 2)
        cudalib.check(x, "x", torch.float32, 1)
        cudalib.check_int32("matvec", n)  # int64 offsets of A's rows
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
