"""The yardstick of ``dense_factor_roofline`` and ``dense_kernels_roofline``:
the work of the port's dense reduced solve, counted from n (the reduced
system's rows, 6 a padded pose block), the stripe width B = 256 and the
compact Schur table, with ``work.py``'s peaks.

Each count is (bytes, operations): each input the call needs read once
and each output written once, in values of ``size`` bytes (fp32: the
dense route's sweeps run in fp32 only).  With K = n / B stripes:

- the factor (``cholesky_ex``): n³/3 operations, A read and L written
  (2 n² values);
- ``compact_to_dense`` (kernel 9): the table's filled slots (36 values
  each), the damped diagonal (36 a pose block) and its [n, n] output; the
  table's two slot ids a slot and one int a 64x128-block tile; one add a
  diagonal element (``tools/roofline.dense_work``'s count);
- ``extract_diag`` (kernel 11): L's K diagonal blocks read and written;
- ``solve_lower`` and ``solve_upper`` (kernels 12, 13): L's strictly-lower
  blocks, the K inverted diagonal blocks, the vector read and the result
  written; two operations a multiply-add of the blocked sweep (``B x B``
  an inverted block, ``(n - (k+1) B) x B`` the update of stripe k);
- ``matvec`` (kernel 14): A [n, n], x and y; 2 n² operations.

The least time of a count is the larger of its bytes over the peak
bandwidth and its operations over the peak fp32 rate.
"""

from __future__ import annotations

from benchmark.work import ELEMENT_BYTES, PEAK_BYTES_PER_S, PEAK_FLOPS

BLOCK = 256  # the sweeps' stripe width (trisolve.BLOCK)
DTYPE = "float32"
SIZE = ELEMENT_BYTES[DTYPE]


def least_seconds(count) -> float:
    nbytes, flops = count
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[DTYPE])


def factor_work(n: int, size: int = SIZE):
    return 2 * n * n * size, n ** 3 / 3


def placement_work(pad_blocks: int, filled_slots: int, table_slots: int, tiles: int,
                   size: int = SIZE):
    """compact_to_dense over a compact Schur table of ``table_slots`` band
    slots, ``filled_slots`` of them holding a block, and ``tiles``
    64x128-block tiles of occupancy."""
    PB = pad_blocks
    return (size * (36 * filled_slots + 36 * PB + 36 * PB * PB) + 4 * (2 * table_slots + tiles),
            36 * PB)


def extract_diag_work(n: int, block: int = BLOCK, size: int = SIZE):
    return 2 * size * n * block, 0


def sweep_work(n: int, block: int = BLOCK, size: int = SIZE):
    K = n // block
    strictly_lower = block * block * K * (K - 1) // 2
    return (size * (strictly_lower + K * block * block + 2 * n),
            2 * (strictly_lower + K * block * block))


def matvec_work(n: int, size: int = SIZE):
    return size * (n * n + 2 * n), 2 * n * n


def kernel_work(n: int, pad_blocks: int, filled_slots: int, table_slots: int, tiles: int):
    """{the port's span of a hand-kernel call: (bytes, operations) of one
    call} for the dense route's kernels 9 and 11-14."""
    sweep = sweep_work(n)
    return {"k.compact_to_dense": placement_work(pad_blocks, filled_slots, table_slots, tiles),
            "k.extract_diag": extract_diag_work(n), "k.solve_lower": sweep,
            "k.solve_upper": sweep, "k.matvec": matvec_work(n)}


def engine_kernel_work(eng):
    """:func:`kernel_work` of an engine of the port on the dense route, from
    its plan's padding and its compact Schur table (``rc.iru``: a pose-block
    row a band slot, -1 where empty; ``rc.occ2``: the tiles)."""
    PB, rc = eng.plan.pad_blocks, eng.rc
    return kernel_work(6 * PB, PB, int((rc.iru >= 0).sum()), rc.iru.numel(), rc.occ2.numel())
