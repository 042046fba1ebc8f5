"""The reduction by the program's spans (vosbench/program_trace.py) and its
figures, against a hand-worked trace; profiling.Trace reads the same
trace as it reads one without the program's spans; and the events kept
from a traced CPU run of the harness."""
import pytest

from vosbench import profiling
from vosbench.profiling import Trace
from vosbench.program_trace import ProgramTrace, keeping_events
from vosbench.tests.test_vosbench_harness import _run as _harness_run

US = 1e-6


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def _span(name, ts, dur):
    return _ev("user_annotation", name, ts, dur)


BENCH = [
    # the benchmark's own spans: two frames of 100 us
    _span("vosbench.frame", 0, 100), _span("vosbench.step", 1, 89),
    _span("vosbench.encode", 5, 25), _span("vosbench.segment", 40, 40),
    _span("vosbench.to_host", 91, 8),
    _span("vosbench.frame", 100, 100), _span("vosbench.step", 101, 89),
    _span("vosbench.encode", 105, 25),
]
PROGRAM = [
    _span("cutie.inference_core.step", 2, 88),
    _span("cutie.steps.encode", 5, 25),
    _span("cutie.models.pixel_encoder", 6, 19),
    _span("cutie.steps.segment", 40, 40),
    _span("cutie.steps.read_memory", 42, 8),
    _span("cutie.inference_core.to_host", 91, 8),
    _span("cutie.inference_core.step", 102, 88),
    # ends a rounding step after its parent: still nested in it
    _span("cutie.steps.encode", 105, 85.001),
]
HOST = [
    _ev("cuda_runtime", "cudaLaunchKernel", 10, 2, correlation=1),
    _ev("cuda_runtime", "cudaLaunchKernel", 45, 2, correlation=2),
    _ev("cuda_runtime", "cudaLaunchKernel", 60, 2, correlation=3),
    _ev("cuda_runtime", "cudaStreamSynchronize", 85, 3, correlation=4),
    _ev("cuda_runtime", "cudaMemcpyAsync", 92, 1, correlation=5),
    _ev("cuda_runtime", "cudaStreamSynchronize", 93, 2, correlation=6),
    _ev("cuda_runtime", "cudaLaunchKernel", 110, 2, correlation=7),
    # in the frame, outside every program span
    _ev("cuda_runtime", "cudaLaunchKernel", 195, 2, correlation=8),
    _ev("cpu_op", "aten::conv2d", 9, 4),
]
DEVICE = [
    _ev("kernel", "conv", 20, 20, correlation=1),
    _ev("kernel", "similarity_kernel", 50, 10, correlation=2),
    _ev("kernel", "decoder", 70, 5, correlation=3),
    _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 93, 2, correlation=5),
    _ev("kernel", "conv", 120, 20, correlation=7),
    _ev("kernel", "tail", 196, 2, correlation=8),
]
EVENTS = BENCH + PROGRAM + HOST + DEVICE


def test_innermost_attribution():
    p = ProgramTrace(EVENTS)
    assert p.window_s == pytest.approx(200 * US) and p.frames == 2
    assert p.busy_s == pytest.approx(59 * US)
    s = p.spans
    assert {k: v.count for k, v in s.items()} == {
        "inference_core.step": 2, "steps.encode": 2, "models.pixel_encoder": 1,
        "steps.segment": 1, "steps.read_memory": 1, "inference_core.to_host": 1}
    # device time: innermost, and at any depth
    assert s["models.pixel_encoder"].self_device_s == pytest.approx(20 * US)
    assert s["steps.encode"].self_device_s == pytest.approx(20 * US)
    assert s["steps.encode"].device_s == pytest.approx(40 * US)
    assert s["steps.read_memory"].device_s == pytest.approx(10 * US)
    assert s["steps.segment"].self_device_s == pytest.approx(5 * US)
    assert s["steps.segment"].device_s == pytest.approx(15 * US)
    assert s["inference_core.step"].self_device_s == 0.0
    assert s["inference_core.step"].device_s == pytest.approx(55 * US)
    assert s["inference_core.to_host"].device_s == pytest.approx(2 * US)
    # launches and waits
    assert s["inference_core.step"].launches == 4
    assert s["steps.segment"].launches == 2 and s["steps.read_memory"].launches == 1
    assert s["steps.encode"].launches == 2
    assert s["inference_core.step"].waits == 1 and s["steps.segment"].waits == 0
    assert s["inference_core.to_host"].waits == 1
    assert p.waits_within(("inference_core.step", "inference_core.to_host")) == 2
    assert p.waits_within(("steps.segment",)) == 0
    # idle: gaps 0-20 (pixel_encoder), 40-50 (read_memory), 60-70
    # (segment), 75-93 (to_host), 95-120 (the second encode), 140-196 and
    # 198-200 (outside)
    assert s["models.pixel_encoder"].self_idle_s == pytest.approx(20 * US)
    assert s["steps.read_memory"].self_idle_s == pytest.approx(10 * US)
    assert s["steps.segment"].self_idle_s == pytest.approx(10 * US)
    assert s["steps.segment"].idle_s == pytest.approx(20 * US)
    assert s["inference_core.to_host"].self_idle_s == pytest.approx(18 * US)
    assert s["steps.encode"].self_idle_s == pytest.approx(25 * US)
    assert s["steps.encode"].idle_s == pytest.approx(45 * US)
    assert s["inference_core.step"].idle_s == pytest.approx(65 * US)
    assert p.outside_idle_s == pytest.approx(58 * US)
    # coverage: 57 of the 59 us launched in frames
    assert p.frame_device_s == pytest.approx(59 * US)
    assert p.covered_s == pytest.approx(57 * US)


def test_idle_adds_up_to_the_benchmark_idle():
    p, t = ProgramTrace(EVENTS), Trace(EVENTS)
    credited = sum(v.self_idle_s for v in p.spans.values()) + p.outside_idle_s
    assert credited == pytest.approx(t.window_s - t.busy_s)
    assert p.window_s == t.window_s and p.busy_s == pytest.approx(t.busy_s)


def test_benchmark_trace_ignores_the_program_spans():
    with_spans, without = Trace(EVENTS), Trace(BENCH + HOST + DEVICE)
    assert with_spans.launches == without.launches
    assert with_spans.span_count == without.span_count
    assert dict(with_spans.span_device_s) == dict(without.span_device_s)
    assert dict(with_spans.idle_by_label) == dict(without.idle_by_label)
    assert with_spans.breakdown() == without.breakdown()


def test_figures():
    f = ProgramTrace(EVENTS).figures()
    assert f["steps.segment_ms"] == pytest.approx(15e-3)        # one call
    assert f["steps.segment_idle_ms"] == pytest.approx(10e-3)   # 20 us, 2 steps
    assert f["inference_core.syncs_per_frame"] == 1.0


def test_figures_without_program_spans():
    """A program without spans reduces to no span and no figure, raising
    nothing; the gaps all go to outside."""
    events = BENCH + HOST + DEVICE
    p, t = ProgramTrace(events), Trace(events)
    assert p.spans == {} and p.figures() == {}
    assert p.outside_idle_s == pytest.approx(t.window_s - t.busy_s)


def test_table_lines():
    lines = ProgramTrace(EVENTS).table()
    assert lines[1].startswith("cutie.inference_core.step")
    assert len(lines) == 1 + 6 + 4 + 3
    # 141 of 200 us idle; 57 of 59 us covered; two frames of 100 us
    assert lines[-6].endswith("70.500% of the window")
    assert lines[-5].endswith("96.61%")
    assert lines[-4] == "frames: 2, 0.100 ms a frame (host, frame spans)"
    assert lines[-1] == "inference_core.syncs_per_frame: 1.0000"


def test_keeping_events_on_a_traced_cpu_run():
    """The events of the harness's traced run, kept on the way, reduce by
    the port's spans: one step span a frame, each step's layers in it; and
    load_events is put back afterwards."""
    load = profiling.load_events
    with keeping_events() as events:
        r = _harness_run("small.d17", seconds=3.0, trace=True)
    assert profiling.load_events is load
    assert r["correct"], r["check"]
    p = ProgramTrace(events)
    assert p.frames == 6 and p.spans["inference_core.step"].count == 6
    for name in ("inference_core.upload", "inference_core.to_host",
                 "steps.encode", "steps.segment", "models.pixel_encoder",
                 "models.object_transformer", "models.mask_decoder"):
        assert p.spans[name].count >= 6, name
    assert p.frame_s > 0 and set(p.figures()) == {
        "steps.segment_ms", "steps.segment_idle_ms",
        "inference_core.syncs_per_frame"}
