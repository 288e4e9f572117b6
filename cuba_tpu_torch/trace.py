"""The port's spans: named host ranges on ``torch.profiler``'s timeline.

``span(name)`` is a context manager.  While ``torch.profiler`` records,
it is ``record_function("cuba." + name)``: the range lands on the
profiler's timeline beside the operations and kernels launched inside it,
on one clock with the device trace.  While it does not, it is one shared
no-op, so an unprofiled run pays a flag read a span.

The names (``PERF.md`` §3 lists them with the metrics that read them):

- the symbolic pass: ``structure``, with ``structure.band_perm``,
  ``structure.locality`` and ``structure.symbolic``;
- the planner and the upload: ``engine``, with ``engine.resolve``,
  ``engine.plan_rows`` (``plan.row_tables``, ``plan.schur_lane_csr``) and
  ``engine.upload``, one a host-to-device copy of the planner's or the
  engine's tables;
- the LM loop: ``optimize``, its five phases ``lm.error``, ``lm.build``,
  ``lm.schur``, ``lm.decomp`` and ``lm.update``, and ``read.accept``,
  ``read.cr_boost``, ``read.dense_boost``, ``read.cg_stop`` and
  ``read.chis``, one a device-to-host read that ``LMResult.host_reads``
  counts;
- the per-attempt algebra: ``rows.edge_residuals``, ``rows.edge_terms``,
  ``rows.prepare_factors``, ``rows.back_substitute``,
  ``rows.schur_matvec``, ``rows.block_diag_inv``, and the reduced
  solvers' ``cr.factor``, ``cr.solve`` and ``dense``: the whole dense
  solve, with ``dense.factor`` (one ``dense.cholesky`` a factorisation,
  the first and each boost retry), ``dense.prepare`` (the diagonal
  blocks' inverses, where the blocked sweeps run) and ``dense.solve``;
- the hand kernels: ``k.<kernel>``, one a wrapper call of
  ``ops/segmm.py`` or ``solver/trisolve.py``, ``k.edge_terms`` one
  ``edgerows.term_rows`` call (``ops/edgeterms.py``), or
  ``k.hll_inverse`` / ``k.slot_factors`` one ``rows.hll_inverse_rows`` /
  ``rows.slot_factors_rows`` call inside ``rows.prepare_factors``
  (``ops/factors.py``); the plain versions too.
"""

from __future__ import annotations

from torch.autograd import profiler as _profiler

PREFIX = "cuba."


class _Off:
    """The span of an unprofiled run: enters and leaves, records nothing."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A range named ``"cuba." + name`` while the profiler records, else
    a shared no-op.  The flag is read at every call: the profiler may
    start or stop between two spans."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(PREFIX + name)
    return _OFF
