"""The port's spans as the benchmark reads them.

The port names its layers with ``cuba.*`` ranges on ``torch.profiler``'s
timeline (``cuba_tpu_torch/trace.py``).  :func:`program_spans` makes one
request after the window under the profiler, with host and device
activity, and keeps each ``cuba.*`` span's host interval and the device
time of the kernels launched inside it.  Every reader of a span metric
shares that one request (it is kept on the run).

A kernel is tied to its span by its launch: the profiler gives a device
operation the correlation id of the runtime call that launched it
(``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...), and that call's host
time lies inside the spans that were open, innermost last.  The hand
kernels, launched through ``ctypes``, are tied the same way as torch's own.
The ranges' annotations on the device's side are not kernels.

The arithmetic (:func:`attach`, :func:`host_us`, :func:`device_us`) works
on plain lists, so that the CPU tests can hold it to hand-built spans.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional, Tuple

from benchmark.trace import RANGE_PREFIX, _pad, union_us

PREFIX = "cuba."
RANGE_PREFIXES = (PREFIX, RANGE_PREFIX)  # host ranges; their device annotations are not kernels
RUNTIME_PREFIX = "cu"  # the CUDA API's calls: cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync
QUEUE_FULL = "Command Buffer Full"  # the host waiting for room in the launch queue


@dataclasses.dataclass
class Span:
    """One ``cuba.*`` span: its name (without the prefix), its host
    interval in µs, and the device µs of the kernels launched inside it,
    its subtree's (:func:`attach`)."""

    name: str
    start: float
    end: float
    device_us: float = 0.0


@dataclasses.dataclass
class Launch:
    """A device operation: the host time of the call that launched it, its
    device µs and its name."""

    t: float
    device_us: float
    name: str


@dataclasses.dataclass
class ProgramSpans:
    """One profiled request: its spans, its kernels by innermost span
    (``{(span name or None, kernel name): device µs}``), the host µs of
    the CUDA runtime's calls by innermost span (``host_calls``, keyed
    alike: where the host waits on the card outside a ``read.*`` span, a
    synchronising call or a full launch queue shows), its LM attempts and
    its host wall (``Run.request``'s, under the profiler)."""

    spans: List[Span]
    by_kernel: Dict[Tuple[Optional[str], str], float]
    host_calls: Dict[Tuple[Optional[str], str], float]
    attempts: int
    wall_s: float

    def per_attempt(self, value: float) -> Optional[float]:
        return value / self.attempts if self.attempts > 0 else None


def _contains(outer: Span, inner: Span) -> bool:
    return outer.start <= inner.start and inner.end <= outer.end


def _sweep(spans: List[Span], launches: List[Launch]):
    """(the spans open at the launch, innermost last; the launch), for each
    launch in time order.  Spans of one thread nest, so a sweep in time
    order keeps the open ones on a stack."""
    order = sorted(spans, key=lambda s: (s.start, -s.end))
    stack: List[Span] = []
    i = 0
    for ln in sorted(launches, key=lambda x: x.t):
        while i < len(order) and order[i].start <= ln.t:
            while stack and not _contains(stack[-1], order[i]):
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1].end < ln.t:
            stack.pop()
        yield stack, ln


def by_innermost(spans: List[Span], launches: List[Launch]):
    """``{(innermost span's name or None, name): summed µs}`` of the
    launches (or host calls)."""
    out: Dict[Tuple[Optional[str], str], float] = {}
    for stack, ln in _sweep(spans, launches):
        key = (stack[-1].name if stack else None, ln.name)
        out[key] = out.get(key, 0.0) + ln.device_us
    return out


def attach(spans: List[Span], launches: List[Launch]) -> None:
    """Adds each launch's device time to every span whose host interval
    holds its launch (``device_us``)."""
    for stack, ln in _sweep(spans, launches):
        for s in stack:
            s.device_us += ln.device_us


def named(spans: List[Span], name: str) -> List[Span]:
    """The spans called ``name``, or, for a name ending in ``.``, every
    span under that prefix (``read.``)."""
    if name.endswith("."):
        return [s for s in spans if s.name.startswith(name)]
    return [s for s in spans if s.name == name]


def host_us(spans: List[Span], name: str, within: Optional[str] = None) -> float:
    """The host µs inside the spans called ``name`` (a union: nested or
    repeated spans count once), only those inside a span called
    ``within`` where it is given."""
    chosen = named(spans, name)
    if within is not None:
        outer = named(spans, within)
        chosen = [s for s in chosen if any(_contains(o, s) for o in outer)]
    return union_us(sorted((s.start, s.end) for s in chosen))


def device_us(spans: List[Span], name: str) -> float:
    """The device µs of the kernels launched inside the spans called
    ``name`` (after :func:`attach`), each span counted once where spans of
    that name nest."""
    chosen = named(spans, name)
    outermost = [s for s in chosen if not any(o is not s and _contains(o, s) for o in chosen)]
    return sum(s.device_us for s in outermost)


def from_events(events) -> Tuple[List[Span], List[Launch], List[Launch]]:
    """The ``cuba.*`` spans, the device operations (each at its launching
    call's host time) and the runtime's host calls (each with its host
    µs) of a profiler's ``events()``.  A device operation whose launching
    call is not in the trace is left out."""
    from torch.autograd import DeviceType

    spans, runtime, calls, device = [], {}, [], []
    for e in events:
        annotation = getattr(e, "is_user_annotation", False) or e.name.startswith(
            RANGE_PREFIXES)
        if e.device_type == DeviceType.CPU:
            if e.name.startswith(PREFIX):
                spans.append(Span(e.name[len(PREFIX):], e.time_range.start, e.time_range.end))
            elif not annotation and (e.name.startswith(RUNTIME_PREFIX) or e.name == QUEUE_FULL):
                if e.name != QUEUE_FULL:
                    runtime[e.id] = e.time_range.start
                calls.append(Launch(e.time_range.start, e.time_range.end - e.time_range.start,
                                    e.name))
        elif e.device_type == DeviceType.CUDA and not annotation:
            device.append(e)
    launches = [Launch(runtime[e.id], e.time_range.end - e.time_range.start, e.name)
                for e in device if e.id in runtime]
    return spans, launches, calls


def _profiled_request(run) -> Optional[ProgramSpans]:
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}

    def timer(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _pad(run.device)  # a profile's first device events can be lost
            torch.cuda.synchronize()
            result = fn()
            torch.cuda.synchronize()
            _pad(run.device)
            torch.cuda.synchronize()
        out["events"] = prof.events()
        return result

    rec = run.request(run.next_k, timer=timer)
    run.next_k += 1
    spans, launches, calls = from_events(out["events"])
    print(f"program spans: {len(spans)} spans, {len(launches)} device operations; request "
          f"wall {rec['wall_s']:.6f} s under the profiler, optimize "
          f"{host_us(spans, 'optimize') / 1e6:.6f} s, {rec['nattempts']} attempts",
          file=sys.stderr)
    if not spans:
        return None
    attach(spans, launches)
    return ProgramSpans(spans, by_innermost(spans, launches), by_innermost(spans, calls),
                        rec["nattempts"], rec["wall_s"])


def program_spans(run) -> Optional[ProgramSpans]:
    """The spans of one request made after the window under the profiler,
    made once a run and kept on it; None on the CPU (no device trace) or
    where the trace holds no ``cuba.*`` span (a program without them)."""
    if not hasattr(run, "_program_spans"):
        run._program_spans = None if run.device == "cpu" else _profiled_request(run)
    return run._program_spans
