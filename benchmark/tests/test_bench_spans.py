"""CPU tests of ``benchmark/spans.py`` and the readers of the port's spans
on hand-built span lists: a span's device time by subtree and by innermost
span, host time as a union inside another span, the links from the
profiler's device operations to their launching calls, and each reader's
arithmetic and its None where there is nothing to read.

    python -m pytest benchmark/tests -q
"""

import types

import pytest
from torch.autograd import DeviceType

from benchmark import run, spans
from benchmark.spans import Launch, ProgramSpans, Span


def _tree():
    """An optimize of two attempts: each an error phase (one kernel), a
    decomposition with a read inside (a boost read, no kernel), an accept
    read; a kernel launched outside every span."""
    s = [Span("optimize", 0, 100)]
    for base in (0, 50):
        s += [Span("lm.error", base + 1, base + 20), Span("k.gather_cols", base + 2, base + 5),
              Span("lm.decomp", base + 20, base + 40),
              Span("read.cr_boost", base + 30, base + 35),
              Span("read.accept", base + 41, base + 49)]
    launches = [Launch(3, 7.0, "gather"), Launch(10, 2.0, "gemm"), Launch(53, 7.0, "gather"),
                Launch(25, 4.0, "trsm"), Launch(120, 9.0, "copy")]
    return s, launches


def _fake(ps, device="cuda"):
    return types.SimpleNamespace(device=device, _program_spans=ps)


def test_attach_sums_by_subtree_and_innermost():
    s, launches = _tree()
    spans.attach(s, launches)
    assert [x.device_us for x in s[:3]] == [20.0, 9.0, 7.0]  # 120 lies outside
    assert spans.by_innermost(s, launches) == {
        ("k.gather_cols", "gather"): 14.0, ("lm.error", "gemm"): 2.0, ("lm.decomp", "trsm"): 4.0,
        (None, "copy"): 9.0}
    assert spans.device_us(s, "lm.error") == 16.0
    assert spans.device_us(s, "lm.decomp") == 4.0


def test_device_time_counts_nested_spans_of_one_name_once():
    s = [Span("lm.build", 0, 10), Span("lm.build", 2, 4)]
    spans.attach(s, [Launch(3, 5.0, "k")])
    assert spans.device_us(s, "lm.build") == 5.0


def test_host_time_is_a_union_inside_its_parent():
    s, _ = _tree()
    assert spans.host_us(s, "optimize") == 100
    assert spans.host_us(s, "read.", "optimize") == 2 * (5 + 8)
    # nested or overlapping spans of one name count once; outside ones not at all
    s += [Span("read.accept", 42, 45), Span("read.accept", 150, 160)]
    assert spans.host_us(s, "read.", "optimize") == 2 * (5 + 8)
    assert spans.host_us(s, "read.") == 2 * (5 + 8) + 10
    assert spans.host_us(s, "engine") == 0.0


def _event(name, dev, t0, t1, id_, annotation=False):
    return types.SimpleNamespace(name=name, device_type=dev, id=id_,
                                 is_user_annotation=annotation,
                                 time_range=types.SimpleNamespace(start=t0, end=t1))


def test_from_events_links_device_operations_to_their_launch():
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        _event("cuba.k.gather_cols", cpu, 10, 50, 2, True),
        _event("Activity Buffer Request", cpu, 12, 40, 2),
        _event("cudaLaunchKernel", cpu, 45, 48, 77),
        _event("gather_cols_kernel", cuda, 60, 63, 77),
        _event("cuba.k.gather_cols", cuda, 60, 63, 2, True),  # the range's annotation
        _event("bench: optimize", cuda, 0, 99, 1),
        _event("aten::mm", cpu, 70, 80, 5),
        _event("cudaLaunchKernelExC", cpu, 72, 74, 89),
        _event("xmma_gemm", cuda, 75, 79, 89),
        _event("Memcpy DtoH", cuda, 90, 91, 121),  # its call fell outside the trace
        _event("Command Buffer Full", cpu, 81, 89, 77),  # an id is no link here
    ]
    got_spans, launches, calls = spans.from_events(events)
    assert got_spans == [Span("k.gather_cols", 10, 50)]
    assert launches == [Launch(45, 3, "gather_cols_kernel"), Launch(72, 4, "xmma_gemm")]
    assert calls == [Launch(45, 3, "cudaLaunchKernel"), Launch(72, 2, "cudaLaunchKernelExC"),
                     Launch(81, 8, "Command Buffer Full")]
    assert spans.by_innermost(got_spans, calls) == {
        ("k.gather_cols", "cudaLaunchKernel"): 3, (None, "cudaLaunchKernelExC"): 2,
        (None, "Command Buffer Full"): 8}


def _ps(attempts=2, engine=False):
    s, launches = _tree()
    if engine:
        s += [Span("engine", 200, 300), Span("engine.plan_rows", 210, 280),
              Span("engine.upload", 220, 230), Span("engine.upload", 260, 275),
              Span("engine.upload", 262, 270), Span("engine.upload", 400, 410)]
    calls = [Launch(31, 3.0, "cudaStreamSynchronize"), Launch(60, 1.0, "cudaLaunchKernel")]
    spans.attach(s, launches)
    return ProgramSpans(s, spans.by_innermost(s, launches), spans.by_innermost(s, calls),
                        attempts, 1e-4)


@pytest.mark.parametrize("suffix", ["", ".device", ".large"])
def test_lm_readers(suffix):
    ps = _ps()
    host = run.load_reader("lm_host_ms_per_attempt" + suffix)
    wait = run.load_reader("read_wait_ms_per_attempt" + suffix)
    algebra = run.load_reader("algebra_device_ms_per_attempt" + suffix)
    # (100 - 26) us of host over 2 attempts; 26 us in reads; the error
    # phases' 16 device us
    assert host(_fake(ps)) == pytest.approx(0.037)
    assert wait(_fake(ps)) == pytest.approx(0.013)
    assert algebra(_fake(ps)) == pytest.approx(0.008)
    # host + wait, times attempts, is the optimize span
    assert (host(_fake(ps)) + wait(_fake(ps))) * ps.attempts == pytest.approx(0.1)
    for reader in (host, wait, algebra):
        assert reader(_fake(None)) is None
        assert reader(_fake(ProgramSpans([Span("engine", 0, 5)], {}, {}, 2, 1.0))) is None
        assert reader(_fake(_ps(attempts=0))) is None


def test_planner_readers():
    plan, upload = run.load_reader("plan_host_s"), run.load_reader("upload_s")
    ps = _ps(engine=True)
    # uploads inside engine: 10 + 15 us (the nested one counts once; 400-410 is outside)
    assert upload(_fake(ps)) == pytest.approx(25e-6)
    assert plan(_fake(ps)) == pytest.approx(75e-6)
    for reader in (plan, upload):
        assert reader(_fake(_ps())) is None  # a solve request builds no engine
        assert reader(_fake(None)) is None


def test_program_spans_is_none_on_the_cpu_and_made_once():
    def refuse(*_a, **_k):
        raise AssertionError("no profiled request on the CPU")

    fake = types.SimpleNamespace(device="cpu", request=refuse)
    assert spans.program_spans(fake) is None and fake._program_spans is None
    ps = _ps()
    assert spans.program_spans(_fake(ps)) is ps


def test_span_table_splits_device_time_by_innermost_span():
    from benchmark import span_table

    t = span_table.tables(_ps(), top=2)
    assert t["attempts"] == 2 and t["device_ms"] == pytest.approx(0.029)
    assert t["by_span"][0] == ["k.gather_cols", pytest.approx(0.007),
                               pytest.approx(100 * 14 / 29)]
    assert [row[0] for row in t["by_span"]] == ["k.gather_cols", "(no span)", "lm.decomp",
                                                "lm.error"]
    assert t["kernels"][0] == ["gather", pytest.approx(0.007),
                               {"k.gather_cols": pytest.approx(0.007)}]
    assert len(t["kernels"]) == 2
    assert t["host_ms"] == {"lm.decomp": pytest.approx(0.02), "lm.error": pytest.approx(0.019),
                            "read.accept": pytest.approx(0.008),
                            "read.cr_boost": pytest.approx(0.005)}
    assert t["host_calls"] == [["read.cr_boost", "cudaStreamSynchronize", pytest.approx(0.0015)],
                               ["lm.error", "cudaLaunchKernel", pytest.approx(0.0005)]]
