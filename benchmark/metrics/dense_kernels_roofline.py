"""dense_kernels_roofline: the dense route's hand kernels' share of their
roofline, in percent: the summed least time of every call of kernels 9 and
11-14 (``compact_to_dense``, ``extract_diag``, ``solve_lower``,
``solve_upper``, ``matvec``: one port span ``cuba.k.<kernel>`` a call,
each call's work from ``dense_work.engine_kernel_work``) over the summed
device time of the kernels launched inside those spans, in the request
that ``benchmark/spans.py`` profiles after the window.  Nothing where the
request makes none of those calls."""

from benchmark import dense_work, spans


def read(run):
    ps = spans.program_spans(run)
    eng = getattr(run, "engine", None)
    if ps is None or eng is None:
        return None
    work = dense_work.engine_kernel_work(eng)
    least = sum(len(spans.named(ps.spans, name)) * dense_work.least_seconds(count)
                for name, count in work.items())
    seconds = sum(spans.device_us(ps.spans, name) for name in work) * 1e-6
    return 100.0 * least / seconds if seconds > 0 else None
