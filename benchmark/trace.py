"""Reading the device trace: ``torch.profiler`` over a few requests, the
union of the device intervals (the device's busy time), the device
operations, and the device's idle gaps named by what the host was doing.

A profiler session can lose some of its first and its last device events,
so a traced request sits between two ``torch.cuda._sleep`` marks, with
untimed device work before the first and after the last (the arithmetic
of the repository's ``chip_smoke.py``, ``union_us`` and ``device_ops``).
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Callable, List, Tuple

import torch

PAD_OPS = 256  # untimed device operations before the first mark and after the last
RANGE_PREFIX = "bench: "  # the benchmark's own host ranges


def union_us(spans) -> float:
    """The union of sorted (start, end) intervals, in their unit."""
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _pad(device) -> None:
    x = torch.zeros(1, device=device)
    for _ in range(PAD_OPS):
        x.add_(1.0)


@dataclasses.dataclass
class Traced:
    wall_s: float  # host wall of the traced call, ending in a synchronize
    device_events: List[Tuple[float, float, str]]  # (start us, end us, name)
    host_events: List[Tuple[float, float, str]]  # CPU-side events (with host=True)

    @property
    def busy_s(self) -> float:
        return union_us((a, b) for a, b, _ in self.device_events) / 1e6

    def top_device_ops(self, n: int = 10):
        by_name = {}
        for a, b, name in self.device_events:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        return sorted(by_name.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        """The device's idle time between its first and last operation of
        the call, summed by the innermost host event that spans each gap's
        midpoint (an aten operation, a CUDA runtime call or one of the
        benchmark's own ranges), largest first."""
        spans = sorted((a, b) for a, b, _ in self.device_events)
        # from the start of the call's first host event to the end of its
        # last: idle time before the first device operation counts too
        lo = min([spans[0][0]] + [a for a, _b, _n in self.host_events])
        hi = max([spans[-1][1]] + [b for _a, b, _n in self.host_events])
        gaps, end = [], lo
        for a, b in spans + [(hi, hi)]:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        # host events nest, so of those that span a point the innermost
        # ends first: sweep the midpoints with a heap of events by end
        hosts = sorted(self.host_events)
        by_name, heap, i = {}, [], 0
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = 0.5 * (a + b)
            while i < len(hosts) and hosts[i][0] <= mid:
                heapq.heappush(heap, (hosts[i][1], hosts[i][2]))
                i += 1
            while heap and heap[0][0] < mid:
                heapq.heappop(heap)
            name = heap[0][1] if heap else "(no host event)"
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        return sorted(by_name.items(), key=lambda kv: -kv[1])[:n]


def traced(fn: Callable[[], object], device, host: bool = False):
    """(``fn()``, its :class:`Traced`): ``fn`` run under ``torch.profiler``
    (device activity; with ``host``, the host's too), between two marks.
    The trace is None where it split wrongly or held no device
    operation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        _pad(device)
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        torch.cuda._sleep(1)
        _pad(device)
        torch.cuda.synchronize()
    events = prof.events()
    # with host activity, record_function ranges also appear on the device's
    # side as annotations spanning their kernels: not device operations
    dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)
                 and not e.name.startswith(RANGE_PREFIX))
    marks = [i for i, (_a, _b, name) in enumerate(dev) if "spin_kernel" in name]
    if len(marks) < 2:
        return result, None
    inside = dev[marks[0] + 1:marks[1]]
    if not inside:
        return result, None
    hosts = []
    if host:
        lo, hi = inside[0][0], inside[-1][1]
        hosts = [(e.time_range.start, e.time_range.end, e.name) for e in events
                 if e.device_type == DeviceType.CPU and e.time_range.end >= lo
                 and e.time_range.start <= hi and e.name != "Activity Buffer Request"]
    return result, Traced(wall_s=wall, device_events=inside, host_events=hosts)
