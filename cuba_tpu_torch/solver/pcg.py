"""Block-Jacobi preconditioned conjugate gradient on the AoS Schur
complement, matrix-free (port of ``cuba_tpu/solver/pcg.py``):

    Hsc x = Hpp_d x - W (Hpl^T x)

with two gathers and two CSR segment sums per matvec.  The preconditioner
is the exact 6x6 block diagonal of Hsc, inverted.  The stop test reads the
host once per step, as the rows path's PCG does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cuba_tpu_torch import trace
from cuba_tpu_torch.solver.assembly import segment_sum
from cuba_tpu_torch.solver.schur import SchurConsts


class SchurOperator(NamedTuple):
    Hpp_d: torch.Tensor  # damped [P,6,6]
    Hpl: torch.Tensor  # [n_hpl,6,3]
    W: torch.Tensor  # Hpl invHll per slot [n_hpl,6,3]
    sc: SchurConsts
    num_p: int
    num_l: int

    def slot_product(self, x: torch.Tensor) -> torch.Tensor:
        """W (Hpl^T x) summed by pose over the slots [P,6]."""
        sc = self.sc
        a = segment_sum(torch.einsum("kij,ki->kj", self.Hpl, x[sc.hpl_row]), sc.hpl_col,
                        self.num_l, sc.csr_col)
        return segment_sum(torch.einsum("kij,kj->ki", self.W, a[sc.hpl_col]), sc.hpl_row,
                           self.num_p, sc.csr_row)

    def slot_diagonal(self) -> torch.Tensor:
        """W Hpl^T summed by pose over the slots [P,6,6]."""
        contrib = torch.einsum("kil,kjl->kij", self.W, self.Hpl)
        return segment_sum(contrib, self.sc.hpl_row, self.num_p, self.sc.csr_row)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """x [P,6] -> Hsc x [P,6]."""
        return torch.einsum("pij,pj->pi", self.Hpp_d, x) - self.slot_product(x)

    def block_diagonal(self) -> torch.Tensor:
        """Exact 6x6 block diagonal of Hsc."""
        return self.Hpp_d - self.slot_diagonal()


def pcg_solve(op: SchurOperator, b: torch.Tensor, max_iterations: int, tol: float):
    """Solve Hsc x = b [P,6].  Returns (x, ok, k): ok is False on
    non-convergence (||r|| > tol ||b|| after max_iterations) or a
    non-finite x, which is then 0; k is the number of CG steps."""
    # inv_ex: a singular block gives non-finite values (and a rejected
    # step) without inv's host synchronisation
    Minv = torch.linalg.inv_ex(op.block_diagonal()).inverse

    def apply_M(r):
        return torch.einsum("pij,pj->pi", Minv, r)

    def dot(a, c):
        return (a * c).sum()

    tol2 = (tol * tol) * dot(b, b)
    x = torch.zeros_like(b)
    r = b
    z = apply_M(r)
    p = z
    rz = dot(r, z)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    k = 0
    while k < max_iterations:
        with trace.span("read.cg_stop"):
            if not bool(dot(r, r) > tol2):
                break
        Ap = op.matvec(p)
        pAp = dot(p, Ap)
        alpha = rz / torch.where(pAp == 0, one, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_M(r)
        rz_new = dot(r, z)
        beta = rz_new / torch.where(rz == 0, one, rz)
        p = z + beta * p
        rz = rz_new
        k += 1
    ok = (dot(r, r) <= tol2) & torch.isfinite(x).all()
    return torch.where(ok, x, torch.zeros_like(x)), ok, k
