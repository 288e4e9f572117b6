"""The hand-written kernels' index arithmetic and summation orders, in
NumPy, for the tests and the probes.

Each walk reproduces one CUDA kernel of ``csrc/segmm.cu`` or
``csrc/trisolve.cu`` as the card runs it: which thread reads and writes
what, and in which order each output's terms are added, with every fp32
FMA rounded once (:func:`fma32`).  The card's tests hold each kernel to its
walk bit for bit; the CPU tests hold each walk to ``cuba_tpu``'s Pallas
kernel or to the plain version.  No module of the solver imports this one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cuba_tpu_torch.ops.segmm import (BAND_THREADS, BAND_TILE, DENSE_TILE_P, DENSE_TILE_Q,
                                      SCHUR_SLOT, SCHUR_SLOT_F64, SCHUR_THREADS, SCHUR_WINDOW,
                                      SchurPlan, SegmentCSR)
from cuba_tpu_torch.solver.trisolve import (BLOCK, DIAG_LOADS, DIAG_PASS, LOWER_TILE,
                                            MATVEC_ACCS, QUADS, THREADS, UPPER_TILE,
                                            diag_launch, matvec_slices, solve_upper_tile)


def fma32(a, b, c):
    """fp32 fused multiply-add rounded once, as the card's ``__fmaf_rn``:
    the product of two fp32 values is exact in fp64; the fp64 sum is rounded
    to odd (its error from TwoSum), which an fp32 rounding then takes to the
    correctly rounded result."""
    p = np.asarray(a, np.float32).astype(np.float64) * np.asarray(b, np.float32)
    c = np.asarray(c, np.float32).astype(np.float64)
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((err != 0) & even, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def segsum_walk(vals: np.ndarray, csr: SegmentCSR, group: Optional[int] = None) -> np.ndarray:
    """The CUDA segment sum's exact summation order, in NumPy (for tests):
    lane k of segment s's group of G lanes (``group``, by default the
    CSR's, as the kernel takes it) sums entries offs[s] + k,
    offs[s] + k + G, ... in order, from 0; then, for o = G/2, ..., 1, every
    lane adds lane (k xor o)'s partial.  Returns [D, num_out] in fp64 for
    fp64 ``vals`` (the kernel's fp64 build), else in fp32."""
    dt = np.float64 if np.asarray(vals).dtype == np.float64 else np.float32
    vals = np.asarray(vals, dt)
    order, offs = csr.order.cpu().numpy(), csr.offs.cpu().numpy()
    G = csr.group if group is None else group
    out = np.zeros((vals.shape[0], offs.size - 1), dt)
    lanes = np.arange(G)
    for s in np.flatnonzero(np.diff(offs)):
        cols = order[offs[s]:offs[s + 1]]
        part = np.zeros((G, vals.shape[0]), dt)
        for k in range(min(G, cols.size)):
            run = vals[:, cols[k::G]]
            # cumsum adds left to right: the lane's serial chain, from +0
            part[k] = np.cumsum(np.concatenate([part[k][:, None], run], axis=1), axis=1,
                                dtype=dt)[:, -1]
        o = G // 2
        while o:
            part = part + part[lanes ^ o]
            o //= 2
        out[:, s] = part[0]
    return out


def fma64_exact_products(a, b, c):
    """fp64 fused multiply-add, as the card's ``__fma_rn``, where the
    product a * b is exact in fp64 (each factor an fp32 value: 24-bit
    significands): the one rounding is then the sum's."""
    return np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)


def schur_fused_walk(W, G, plan: SchurPlan, sb, li, lj, csr: SegmentCSR) -> np.ndarray:
    """``schur_fused_kernel``'s exact order, in NumPy (for tests): for
    every output (lane, a*6+b), from 0, each triplet t of the lane's CSR
    segment (ascending t; li or lj < 0 dropped) adds its three products by
    a fused multiply-add, m = 0, 1, 2: s = fma(W[3a+m, i_t], G[3b+m, j_t],
    s) with i_t = sb[c]*SB + li[t].  Returns [36, C*kwin] of W's dtype: fp32
    by :func:`fma32`; fp64 by :func:`fma64_exact_products`, so W and G in
    fp64 must hold fp32 values (else ValueError)."""
    if np.asarray(W).dtype == np.float64:
        W, G = np.asarray(W, np.float64), np.asarray(G, np.float64)
        for x in (W, G):
            if not np.array_equal(x.astype(np.float32).astype(np.float64), x):
                raise ValueError("the fp64 walk needs fp32 values in W and G (exact products)")
        dt, fma = np.float64, fma64_exact_products
    else:
        W, G = np.asarray(W, np.float32), np.asarray(G, np.float32)
        dt, fma = np.float32, fma32
    sb, li, lj = (np.asarray(a.cpu().numpy() if isinstance(a, torch.Tensor) else a, np.int64)
                  for a in (sb, li, lj))
    order, offs = csr.order.cpu().numpy().astype(np.int64), csr.offs.cpu().numpy()
    lanes = offs.size - 1
    length = np.diff(offs)
    base = sb[np.arange(lanes) // plan.kwin] * plan.slot_block
    out = np.zeros((6, 6, lanes), dt)
    for k in range(int(length.max()) if lanes else 0):
        lane = np.flatnonzero(length > k)
        t = order[offs[lane] + k]
        keep = (li[t] >= 0) & (lj[t] >= 0)
        lane, t = lane[keep], t[keep]
        w = W[:, base[lane] + li[t]].reshape(6, 1, 3, -1)
        g = G[:, base[lane] + lj[t]].reshape(1, 6, 3, -1)
        s = out[:, :, lane]
        for m in range(3):
            s = fma(w[:, :, m], g[:, :, m], s)
        out[:, :, lane] = s
    return out.reshape(36, lanes)


def schur_stage_walk(dtype=torch.float32):
    """``schur_fused_kernel``'s staging of the W and G windows for
    ``dtype``, in NumPy: a 16-byte load holds V = 4 floats or 2 doubles;
    for load u < 36*512/V / SCHUR_THREADS of thread t (in batches of 18: one
    in fp32, two in fp64), v = t + u * SCHUR_THREADS, the load reads row
    r = v % 36 (W's rows 0-17, G's 18-35) at column group q = v // 36 of
    the window, and its V values go to shared element r' + (V*q + c) *
    slot, c < V, with r' = r for W, and for G (r - 18) plus the W
    window's SCHUR_WINDOW * slot elements (slot SCHUR_SLOT in fp32,
    SCHUR_SLOT_F64 in fp64).  Returns (r, q, elements), of shapes [loads,
    threads], [loads, threads] and [loads, threads, V]."""
    V = 16 // dtype.itemsize
    slot = SCHUR_SLOT if dtype == torch.float32 else SCHUR_SLOT_F64
    loads = 36 * SCHUR_WINDOW // V // SCHUR_THREADS
    v = np.arange(SCHUR_THREADS)[None, :] + SCHUR_THREADS * np.arange(loads)[:, None]
    r, q = v % 36, v // 36
    row = np.where(r < 18, r, r - 18 + SCHUR_WINDOW * slot)
    words = row[..., None] + (V * q[..., None] + np.arange(V)) * slot
    return r, q, words


def compact_to_band_walk(gT, table, dbT, occ, PB: int) -> np.ndarray:
    """``compact_to_band_kernel``'s index arithmetic in NumPy (for tests),
    over all blocks (p, e) at once: thread t of BAND_THREADS takes items v =
    t, t + 192, ... of (r, q) = (v // 64, v % 64), r = i*6 + j, reading its
    row's table entry q (slot, bit 30 for a mirror) and placing -gT[r or
    j*6 + i, slot] (+ dbT[r, p] where e == 0 and q == p % 64) at strip[i,
    6q + j]; then quad v of the strip (row v // 96) goes to out row 6p + i
    of the tile; an unoccupied tile gets zeros.  Returns [M*384, 768]."""
    gT, dbT = np.asarray(gT, np.float32), np.asarray(dbT, np.float32)
    table, occ = np.asarray(table), np.asarray(occ)
    T, M = BAND_TILE, PB // BAND_TILE
    p = np.arange(PB)[:, None, None]
    e = np.arange(2)[None, :, None]
    out = np.zeros((M * 6 * T, 12 * T), np.float32)
    strip = np.zeros((PB, 2, 6, 6 * T), np.float32)
    for t in range(BAND_THREADS):
        v = np.arange(t, 36 * T, BAND_THREADS)[None, None, :]
        r, q = v // T, v % T
        i, j = r // 6, r % 6
        en = table[p, e * T + q]
        row = np.where(en & (1 << 30), j * 6 + i, r)
        val = np.where(en >= 0, -gT[row, np.where(en >= 0, en & ((1 << 30) - 1), 0)],
                       np.float32(0))
        val = np.where((e == 0) & (q == p % T), val + dbT[r, p], val)
        strip[p, e, i, 6 * q + j] = val
    live = occ.reshape(M, 2)[np.arange(PB) // T] > 0  # [PB, 2]
    strip = np.where(live[:, :, None, None], strip, np.float32(0))
    quads = strip.reshape(PB, 2, 6 * 6 * T // 4, 4)
    for t in range(BAND_THREADS):
        v = np.arange(t, 6 * 6 * T // 4, BAND_THREADS)
        i, c4 = v // (6 * T // 4), v % (6 * T // 4)
        rows = (p[:, :, 0] // T * 6 * T + 6 * (p[:, :, 0] % T))[:, :, None] + i  # [PB, 1, n]
        cols = e[:, :, :1] * 6 * T + 4 * c4  # [1, 2, n]
        for c in range(4):
            out[rows, cols + c] = quads[:, :, v, c]
    return out


def compact_to_dense_walk(gT, table, dbT, occ, PB: int):
    """``compact_to_dense_kernel``'s index arithmetic in NumPy (for tests),
    over all blocks (p, e) at once, Q = DENSE_TILE_Q: thread t of
    BAND_THREADS takes items v = t, t + 192, ... of (r, q) = (v // Q, v %
    Q), r = i*6 + j, reading table[p, Q*e + q] (slot, bit 30 for a mirror)
    and placing -gT[r or j*6 + i, slot] (+ dbT[r, p] where Q*e + q == p) at
    strip[i, 6q + j]; then quad v of the strip (row v // (6Q/4)) goes to
    output row 6p + i, columns 6Q*e + 4*(v % (6Q/4)) ...; a block on an
    unoccupied 64xQ-block tile stores zeros.  Returns ([6PB, 6PB], the
    times each output float4 was written)."""
    gT, dbT = np.asarray(gT, np.float32), np.asarray(dbT, np.float32)
    table, occ = np.asarray(table), np.asarray(occ)
    Q, E, n = DENSE_TILE_Q, PB // DENSE_TILE_Q, 6 * PB
    p = np.arange(PB)[:, None, None]
    e = np.arange(E)[None, :, None]
    strip = np.zeros((PB, E, 6, 6 * Q), np.float32)
    for t in range(BAND_THREADS):
        v = np.arange(t, 36 * Q, BAND_THREADS)[None, None, :]
        r, q = v // Q, v % Q
        i, j = r // 6, r % 6
        en = table[p, e * Q + q]
        row = np.where(en & (1 << 30), j * 6 + i, r)
        val = np.where(en >= 0, -gT[row, np.where(en >= 0, en & ((1 << 30) - 1), 0)],
                       np.float32(0))
        val = np.where(e * Q + q == p, val + dbT[r, p], val)
        strip[p, e, i, 6 * q + j] = val
    live = occ.reshape(PB // DENSE_TILE_P, E)[np.arange(PB) // DENSE_TILE_P] > 0  # [PB, E]
    strip = np.where(live[:, :, None, None], strip, np.float32(0))
    per_row = 6 * Q // 4
    quads = strip.reshape(PB, E, 6 * per_row, 4)
    out = np.zeros((n * n // 4, 4), np.float32)
    dst_all = []
    for t in range(BAND_THREADS):
        v = np.arange(t, 6 * per_row, BAND_THREADS)
        i, c4 = v // per_row, v % per_row
        dst = (6 * p + i) * (n // 4) + e * per_row + c4  # [PB, E, len(v)]
        out[dst] = quads[:, :, v]
        dst_all.append(dst.ravel())
    writes = np.bincount(np.concatenate(dst_all), minlength=out.shape[0])
    return out.reshape(n, n), writes


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


def solve_lower_walk(L, invd, b) -> np.ndarray:
    """``solve_lower_kernel``'s order in NumPy (for tests).  Lane q <
    QUADS of a row (its thread in the row's tile) adds, for stripes j = 0,
    1, ..., i-1 of the row's stripe i, the four terms L[row, 256j + 4q + c]
    y[256j + 4q + c] (c = 0..3) into its accumulator, from 0; lanes 0-31
    and 32-63 (two warps) each take a xor butterfly (offsets 16 ... 1) and
    the row's sum is the first warp's plus the second's; r = b - that sum
    (r = b on stripe 0).  Tile t of T = LOWER_TILE rows then forms the
    partial P_t[c] = sum over its rows k, in order, of invd[i][c, k] r[k]
    from 0, and y_i = P_0 + P_1 + ... in tile order.  Stripes are walked in
    order, each adding its y to the accumulators of every later row (the
    same per-row order).  fp32 input is walked with :func:`fma32` (each FMA
    rounded once: the card's bits), fp64 with fp64 FMAs."""
    L, invd, b = np.asarray(L), np.asarray(invd), np.asarray(b)
    dt = L.dtype
    fma = fma32 if dt == np.float32 else (lambda a, b, c: a * b + c)
    n = L.shape[0]
    K = n // BLOCK
    T = LOWER_TILE
    quad = 4 * np.arange(QUADS)
    lanes = np.arange(32)
    acc = np.zeros((n, QUADS), dt)
    y = np.zeros(n, dt)
    for i in range(K):
        lo, hi = i * BLOCK, (i + 1) * BLOCK
        r = b[lo:hi].copy()
        if i:
            h = acc[lo:hi].reshape(BLOCK, 2, 32)
            o = 16
            while o:
                h = h + h[..., lanes ^ o]
                o //= 2
            r = r - (h[:, 0, 0] + h[:, 1, 0])
        yi = None
        for t in range(BLOCK // T):
            p = np.zeros(BLOCK, dt)
            for k in range(t * T, (t + 1) * T):
                p = fma(invd[i][:, k], r[k], p)
            yi = p if yi is None else yi + p
        y[lo:hi] = yi
        for c in range(4):
            acc[hi:] = fma(L[hi:, lo + quad + c], yi[quad + c], acc[hi:])
    return y


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
