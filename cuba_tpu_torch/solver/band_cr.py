"""Block-tridiagonal cyclic reduction for banded Schur complements (port of
``cuba_tpu/solver/band_cr.py``).

The band is held as D [m, B, B] diagonal blocks and U [m, B, B]
super-diagonal blocks (U[k] = A[k, k+1], U[m-1] = 0), B = 384 = 64 pose
blocks.  Odd-even cyclic reduction eliminates the odd block rows level by
level: log2(m) levels of batched 384x384 matmuls and one batched SPD
inverse each, then a dense base solve.  The factor keeps every level's
transfer operators, so a refinement re-solve is batched matvecs only.

This is batched dense linear algebra that ``cuba_tpu`` leaves to XLA; here
it is ``torch.matmul``, ``torch.linalg.cholesky_ex`` and
``torch.linalg.solve_triangular`` (cuBLAS and cuSOLVER on the card).  The
numerical contract is ``cuba_tpu``'s: Jacobi equilibration, one fp32
diagonal-boost retry on a non-finite factor, refinement sweeps against the
undamped band operator, and ok=False (a rejected LM step) on a non-finite
result.  The retry decision is one host read per factorisation (``cuba_tpu``
takes it inside the device program with ``lax.cond``).
``cuba_tpu``'s pair-merge knob is not ported: it was measured as a loss.

Loop closures that no pose fold makes local leave a few out-of-band blocks;
:func:`cr_solve_woodbury` factors the band by cyclic reduction and corrects
it over the loop columns by the Woodbury identity.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from cuba_tpu_torch import trace

B = 384  # CR block: 64 pose blocks of 6
POSES_PER_BLOCK = B // 6


def certify(hsc_row, hsc_col, pad_blocks: int) -> int:
    """The CR block count m when every Schur block lands in the same or an
    adjacent CR block (block-tridiagonal storage holds it), else 0."""
    m, ob = certify_lr(hsc_row, hsc_col, pad_blocks)
    return m if ob.size == 0 else 0


def certify_lr(hsc_row, hsc_col, pad_blocks: int):
    """(m, ob_idx): the CR block count (0 if it does not apply) and the
    sorted indices of the out-of-band (loop-closure) blocks."""
    empty = np.zeros(0, np.int64)
    if pad_blocks % POSES_PER_BLOCK != 0:
        return 0, empty
    m = pad_blocks // POSES_PER_BLOCK
    if m < 2 or len(hsc_row) == 0:
        return 0, empty
    r = np.asarray(hsc_row, np.int64)
    c = np.asarray(hsc_col, np.int64)
    out = np.abs(r // POSES_PER_BLOCK - c // POSES_PER_BLOCK) > 1
    return m, np.nonzero(out)[0]


def loop_plan(hsc_row, hsc_col, m: int, ob_idx):
    """The host Woodbury plan of a band that :func:`certify_lr` split as
    (m, ob_idx), where at most 64 loop-closure pose-block columns hold its
    out-of-band blocks (cuba_tpu's ``engine.lr`` and ``plan_mxu``'s
    out-of-band tables), or None: the CR block count ``m``, the out-of-band
    blocks' indices ``ob_idx`` in the Hsc list and their pose rows and
    columns ``obr`` / ``obc``, their indices ``ob_i`` / ``ob_j`` in the
    loop-column set J, and J's scalar rows ``jrows``."""
    if m < 2 or not ob_idx.size:
        return None
    obr = np.asarray(hsc_row, np.int64)[ob_idx]
    obc = np.asarray(hsc_col, np.int64)[ob_idx]
    J = np.unique(np.concatenate([obr, obc]))
    if J.size > 64:
        return None
    return dict(m=m, ob_idx=ob_idx, obr=obr, obc=obc,
                ob_i=np.searchsorted(J, obr).astype(np.int32),
                ob_j=np.searchsorted(J, obc).astype(np.int32),
                jrows=(J[:, None] * 6 + np.arange(6)).reshape(-1).astype(np.int32))


def from_dense(A: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-tridiagonal storage (D, U) sliced out of a dense [m*B, m*B]
    matrix."""
    D = torch.stack([A[k * B:(k + 1) * B, k * B:(k + 1) * B] for k in range(m)])
    U = torch.stack([A[k * B:(k + 1) * B, (k + 1) * B:(k + 2) * B] for k in range(m - 1)]
                    + [A.new_zeros((B, B))])
    return D, U


def ob_from_dense(Dm: torch.Tensor, obr, obc) -> torch.Tensor:
    """The out-of-band 6x6 blocks A[obr[k], obc[k]] [n_ob, 6, 6] gathered
    from a dense Schur matrix (host pose-block indices)."""
    rows = torch.as_tensor(np.asarray(obr, np.int64), device=Dm.device)[:, None] * 6
    cols = torch.as_tensor(np.asarray(obc, np.int64), device=Dm.device)[:, None] * 6
    six = torch.arange(6, device=Dm.device)
    return Dm[(rows + six)[:, :, None], (cols + six)[:, None, :]]


def _inv_spd_chol(M: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse through Cholesky.  A matrix whose factorisation
    fails comes out all NaN: ``cholesky_ex`` reports the failure in ``info``
    instead of NaN, and the boost retry and ``ok`` read non-finite values."""
    L, info = torch.linalg.cholesky_ex(M)
    L = torch.where((info != 0)[..., None, None],
                    torch.full((), float("nan"), dtype=M.dtype, device=M.device), L)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device).expand_as(M)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return Linv.mT @ Linv


def _inv_spd_rs(M: torch.Tensor, leaf: int = 48) -> torch.Tensor:
    """Batched SPD inverse by recursive 2x2 block Schur complements: batched
    matmuls down to ``leaf``-sized Cholesky leaves."""
    n = M.shape[-1]
    if n <= leaf:
        return _inv_spd_chol(M)
    h = n // 2
    A, Bm, C = M[..., :h, :h], M[..., :h, h:], M[..., h:, h:]
    Ai = _inv_spd_rs(A, leaf)
    AiB = Ai @ Bm
    Si = _inv_spd_rs(C - Bm.mT @ AiB, leaf)
    TR = -(AiB @ Si)
    TL = Ai - TR @ AiB.mT
    return torch.cat([torch.cat([TL, TR], dim=-1), torch.cat([TR.mT, Si], dim=-1)], dim=-2)


InvFn = Callable[[torch.Tensor], torch.Tensor]


def factor(D: torch.Tensor, U: torch.Tensor, inv: InvFn = _inv_spd_rs):
    """Cyclic-reduction factorisation of (D, U).  Returns (levels, base):
    per level (Dinv_o, Ue, Uo, R, L), and the inverted base system."""
    levels: List[tuple] = []
    Bd = D.shape[1]
    while D.shape[0] > 2:
        m = D.shape[0]
        ne, no = (m + 1) // 2, m // 2
        De, Do = D[0::2], D[1::2]
        Ue = U[0::2][:no]  # U[2t], t < no
        Uo = U[1::2]  # U[2t+1]
        Dinv_o = inv(Do)
        R = Ue @ Dinv_o  # A[2t, 2t+1] D_{2t+1}^-1
        L = Uo[:ne - 1].mT @ Dinv_o[:ne - 1]
        # reduced diagonal D'_t = D_2t - R_t U_2t^T - L_t U_{2t-1}
        Dn = De.clone()
        Dn[:no] -= R @ Ue.mT
        Dn[1:ne] -= L @ Uo[:ne - 1]
        # reduced super-diagonal U'_t = -R_t U_{2t+1}, t < ne - 1
        Un = torch.cat([-(R[:ne - 1] @ Uo[:ne - 1]), D.new_zeros((1, Bd, Bd))])
        levels.append((Dinv_o, Ue, Uo, R, L))
        D, U = Dn, Un
    if D.shape[0] == 1:
        base = inv(D[0])
    else:
        base = inv(torch.cat([torch.cat([D[0], U[0]], dim=1),
                              torch.cat([U[0].T, D[1]], dim=1)], dim=0))
    return tuple(levels), base


def solve(levels, base: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b with a :func:`factor` result; b [m*B] or [m*B, R]."""
    vec = b.dim() == 1
    bm = b[:, None] if vec else b
    R_ = bm.shape[1]
    if not levels:
        x = base @ bm
        return x[:, 0] if vec else x
    Bd = levels[0][0].shape[-1]
    b_lv = [bm.reshape(bm.shape[0] // Bd, Bd, R_)]
    for (_Dinv_o, _Ue, _Uo, R, L) in levels:
        bb = b_lv[-1]
        m = bb.shape[0]
        ne, no = (m + 1) // 2, m // 2
        bo = bb[1::2]
        bn = bb[0::2].clone()
        bn[:no] -= R @ bo
        bn[1:ne] -= L @ bo[:ne - 1]
        b_lv.append(bn)
    x = (base @ b_lv[-1].reshape(-1, R_)).reshape(-1, Bd, R_)
    for (Dinv_o, Ue, Uo, _R, _L), bb in zip(reversed(levels), reversed(b_lv[:-1])):
        m = bb.shape[0]
        no = m // 2
        # x_odd[t] = Dinv[t] (b_odd[t] - U[2t]^T x_e[t] - U[2t+1] x_e[t+1])
        xe_r = torch.cat([x[1:], x.new_zeros((1, Bd, R_))])
        r = bb[1::2] - Ue.mT @ x[:no]
        r = r - Uo[:no] @ xe_r[:no]
        xn = x.new_empty((m, Bd, R_))
        xn[0::2] = x[:(m + 1) // 2]
        xn[1::2] = Dinv_o @ r
        x = xn
    x = x.reshape(-1, R_)
    return x[:, 0] if vec else x


def matvec(D: torch.Tensor, U: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x for the block-tridiagonal (D, U); x [m*B] or [m*B, R]."""
    vec = x.dim() == 1
    xm = x[:, None] if vec else x
    R_ = xm.shape[1]
    m, Bd = D.shape[0], D.shape[1]
    xb = xm.reshape(m, Bd, R_)
    zx = xb.new_zeros((1, Bd, R_))
    y = D @ xb + U @ torch.cat([xb[1:], zx])
    Ul = torch.cat([U.new_zeros((1, Bd, Bd)), U[:-1]])
    y = (y + Ul.mT @ torch.cat([zx, xb[:-1]])).reshape(-1, R_)
    return y[:, 0] if vec else y


def _factor_equilibrated(D: torch.Tensor, U: torch.Tensor, inv: InvFn = _inv_spd_rs):
    """Jacobi-equilibrate and factor the band, with the fp32 diagonal-boost
    retry on a non-finite factor.  Returns (solve_with, host_reads):
    ``solve_with(rhs)`` solves A x = rhs in the original scaling."""
    Bd = D.shape[1]
    d = torch.diagonal(D, dim1=1, dim2=2)
    s = torch.rsqrt(torch.clamp(d, min=1e-30))
    sr = torch.cat([s[1:], s.new_ones((1, Bd))])
    Ds = D * s[:, :, None] * s[:, None, :]
    Us = U * s[:, :, None] * sr[:, None, :]
    sf = s.reshape(-1)
    reads = 0
    with trace.span("cr.factor"):
        levels, base = factor(Ds, Us, inv)
        if D.dtype == torch.float32:
            # one retry at a strong boost; if that fails too, ok=False rejects
            # the LM step and lambda escalation re-damps
            bad = ~torch.isfinite(base.sum())
            for (Dinv_o, *_rest) in levels:
                bad = bad | ~torch.isfinite(Dinv_o[-1].sum())
            reads = 1
            with trace.span("read.cr_boost"):
                retry = bool(bad)
            if retry:
                eye = torch.eye(Bd, dtype=D.dtype, device=D.device)
                levels, base = factor(Ds + 1e-3 * eye, Us, inv)

    def solve_with(rhs):
        sc = sf if rhs.dim() == 1 else sf[:, None]
        with trace.span("cr.solve"):
            return sc * solve(levels, base, rhs * sc)

    return solve_with, reads


def cr_solve(D: torch.Tensor, U: torch.Tensor, b: torch.Tensor, refinement_steps: int = 0,
             inv: InvFn = _inv_spd_rs):
    """Solve the banded SPD system A x = b.  Returns (x, ok, host_reads):
    x is 0 where ok is False (a non-finite result); ``inv`` is the
    diagonal-block inverse (``_inv_spd_rs``, or ``_inv_spd_chol``)."""
    solve_with, reads = _factor_equilibrated(D, U, inv)
    x = solve_with(b)
    for _ in range(refinement_steps):
        x2 = x + solve_with(b - matvec(D, U, x))
        x = torch.where(torch.isfinite(x2.sum()), x2, x)
    ok = torch.isfinite(x).all()
    return torch.where(ok, x, torch.zeros_like(x)), ok, reads


def cr_solve_woodbury(D: torch.Tensor, U: torch.Tensor, b: torch.Tensor, Vob: torch.Tensor,
                      ob_i: torch.Tensor, ob_j: torch.Tensor, jrows: torch.Tensor,
                      refinement_steps: int = 0, inv: InvFn = _inv_spd_rs):
    """Solve (B + P S P^T) x = b: the band (D, U) plus the out-of-band
    blocks Vob [n_ob, 6, 6] = A[J[ob_i], J[ob_j]] over the loop-column set
    J (jrows [6|J|] its scalar rows).  Returns (x, ok, host_reads) as
    :func:`cr_solve`.

    (B + P S P^T)^-1 = B^-1 - B^-1 P (I + S G)^-1 S P^T B^-1, G = P^T B^-1 P:
    one multi-RHS CR solve with 6|J| + 1 columns, one [6|J|, 6|J|] dense
    solve (``torch.linalg.solve_ex`` in the working dtype; a singular
    capacitance gives NaN and ok False), then batched matvecs per
    refinement sweep.  A Gershgorin shift moves diag(sum_k |S[j, k]|) from S
    into B, which keeps B SPD for the CR factor."""
    n, r6, dt = b.shape[0], jrows.shape[0], b.dtype
    dev = b.device
    six = torch.arange(6, device=dev)
    n_ob = Vob.shape[0]
    bi = (ob_i.long()[:, None, None] * 6 + six[None, :, None]).expand(n_ob, 6, 6).reshape(-1)
    bj = (ob_j.long()[:, None, None] * 6 + six[None, None, :]).expand(n_ob, 6, 6).reshape(-1)
    # the blocks and their mirrors land on distinct entries: placements
    S = torch.zeros((r6, r6), dtype=dt, device=dev)
    S[bi, bj] = Vob.reshape(-1)
    S[bj, bi] = Vob.reshape(-1)
    drow = S.abs().sum(1)
    S = S - torch.diag(drow)
    jr = jrows.long()
    kb, off = jr // B, jr % B
    D = D.clone()
    D[kb, off, off] = D[kb, off, off] + drow

    solve_with, reads = _factor_equilibrated(D, U, inv)
    E = torch.zeros((n, r6), dtype=dt, device=dev)
    E[jr, torch.arange(r6, device=dev)] = 1.0
    Y = solve_with(torch.cat([b[:, None], E], dim=1))
    y, Z = Y[:, 0], Y[:, 1:]
    T = torch.eye(r6, dtype=dt, device=dev) + S @ Z[jr, :]
    sol, info = torch.linalg.solve_ex(T, S)
    sol = torch.where(info != 0, torch.full((), float("nan"), dtype=dt, device=dev), sol)
    W2 = Z @ sol

    def correct(yv):
        return yv - W2 @ yv[jr]

    def full_matvec(x):
        extra = torch.zeros_like(x)
        extra[jr] = S @ x[jr]
        return matvec(D, U, x) + extra

    x = correct(y)
    for _ in range(refinement_steps):
        x2 = x + correct(solve_with(b - full_matvec(x)))
        x = torch.where(torch.isfinite(x2.sum()), x2, x)
    ok = torch.isfinite(x).all()
    return torch.where(ok, x, torch.zeros_like(x)), ok, reads
