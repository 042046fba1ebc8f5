"""Operation and byte counts, the trace reduction and the per-layer
readers, against hand-worked cases."""
from types import SimpleNamespace

import pytest

from vosbench import flops, schedule, spec as specs
from vosbench.check import build_reference
from vosbench.profiling import Trace

H100 = {"fp32_flops": 6.7e13, "bf16_flops": 9.89e14, "hbm_bytes_per_s": 3.35e12}


def test_read_counts_d17():
    # P = 1,620 queries, 8,100 valid keys, Ck 64, top 30, 3 objects, Cv 256
    ops = flops.read_ops(1620, 8100, 64, 30, 3, 256)
    assert ops == 4 * 1620 * 8100 * 64 + 2 * 1620 * 30 * 3 * 256 == 3_433_881_600
    nbytes = flops.read_bytes(1620, 8100, 64, 3, 256)
    assert nbytes == (4 * 8100 * 65 + 4 * 2 * 1620 * 64 + 4 * 3 * 8100 * 256
                      + 4 * 3 * 1620 * 256 + 4 * 8100) == 32_827_680
    # bound by operations: 3.43e9 / 67e12 = 51.3 us against 9.8 us of bytes
    assert flops.read_bound_s(ops, nbytes, H100) == pytest.approx(5.125196e-5)


def test_read_counts_plus720_and_bf16():
    ops = flops.read_ops(3600, 36000, 64, 30, 3, 256)
    assert ops == 4 * 3600 * 36000 * 64 + 2 * 3600 * 30 * 768 == 33_343_488_000
    assert ops / H100["fp32_flops"] == pytest.approx(4.9766e-4, rel=1e-4)
    # bf16 values halve the value rows' bytes only
    assert (flops.read_bytes(10, 100, 64, 3, 256, 4)
            - flops.read_bytes(10, 100, 64, 3, 256, 2)) == 2 * 3 * 100 * 256
    # fewer valid keys than top_k: every key is kept
    assert flops.read_ops(1, 5, 4, 30, 1, 2) == 4 * 5 * 4 + 2 * 5 * 2


def test_consolidation_ops():
    assert flops.consolidation_ops(8100, 128, 64, 3, 256) == (
        4 * 128 * 8100 * 64 + 2 * 128 * 8100 * 769)


def test_peaks_table():
    assert flops.peaks("NVIDIA H100 80GB HBM3") == H100
    assert flops.peaks("some other card") is None


def test_stage_flops_scale_with_pixels():
    cfg = specs.config(specs.load_spec(), "cutie-small")["model"]
    net = build_reference(cfg, 3, "cpu")
    a = flops.stage_flops(net, 1, 2, 32, 48, "cpu")
    b = flops.stage_flops(net, 1, 2, 64, 48, "cpu")
    # the encoder is convolutions only: exactly linear in the pixels
    assert b["encode"] == 2 * a["encode"]
    # ResNet-18's stem alone: 64 filters of 7x7x3 at stride 2
    assert a["encode"] > 2 * 64 * 3 * 49 * 16 * 24
    assert a["memorize"] > 0 and a["segment"] > 0


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def _trace():
    # two frames (0-100 us, 100-200 us) on the host; kernels on the card
    ev = [
        _ev("user_annotation", "vosbench.frame", 0, 100),
        _ev("user_annotation", "vosbench.encode", 5, 30),
        _ev("user_annotation", "vosbench.memorize", 50, 30),
        _ev("user_annotation", "vosbench.frame", 100, 100),
        _ev("user_annotation", "vosbench.encode", 105, 30),
        _ev("cuda_runtime", "cudaLaunchKernel", 10, 2, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 60, 2, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 110, 2, correlation=3),
        _ev("cuda_runtime", "cudaMemcpyAsync", 150, 2, correlation=4),
        _ev("cuda_runtime", "cudaLaunchKernel", 300, 2, correlation=5),
        _ev("kernel", "conv", 20, 20, correlation=1),
        _ev("kernel", "similarity_kernel", 70, 10, correlation=2),
        _ev("kernel", "conv", 120, 20, correlation=3),
        _ev("gpu_memcpy", "Memcpy DtoH", 160, 10, correlation=4),
        _ev("cpu_op", "aten::conv2d", 9, 4),
    ]
    return Trace(ev)


def test_trace_reduction():
    t = _trace()
    assert t.window_s == pytest.approx(200e-6)
    assert t.busy_s == pytest.approx(60e-6)
    assert t.launches == 3          # the memcpy is no launch; 300 us is outside
    assert t.span_count == {"frame": 2, "encode": 2, "memorize": 1}
    assert t.span_device_s["encode"] == pytest.approx(40e-6)
    assert t.span_device_s["memorize"] == pytest.approx(10e-6)
    assert t.span_device_s["frame"] == pytest.approx(60e-6)
    # gaps: 0-20 (launched in encode), 40-70 (memorize), 80-120 (encode),
    # 140-160 (frame), 170-200 (after the last operation)
    assert t.idle_by_label["encode"] == pytest.approx(60e-6)
    assert t.idle_by_label["memorize"] == pytest.approx(30e-6)
    assert t.idle_by_label["frame"] == pytest.approx(20e-6)
    assert t.idle_by_label["outside_frames"] == pytest.approx(30e-6)
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["conv", pytest.approx(40e-6)]


def test_readers():
    t = _trace()
    frames = [dict(kind="plain", event=None, objects=3, reads=[[8100, 3]],
                   memorized=0, consolidate=False, lt=0),
              dict(kind="memory", event=None, objects=3, reads=[[8100, 3]],
                   memorized=3, consolidate=False, lt=0)]
    run = SimpleNamespace(
        trace=t, traced_frames=frames, peak=H100, queries=1620,
        batch=1, value_bytes=4, core=specs.traffic("d17")["core"],
        model=specs.config(specs.load_spec(), "cutie-base")["model"],
        stage_flops={3: {"encode": 1e9, "segment": 2e9, "memorize": 5e8}},
        frame_ms=[10.0] * 19 + [30.0], window_s=0.25, setup_s=3.5)
    r = lambda name: specs.reader(name)(run)  # noqa: E731
    assert r("fps") == 80.0 and r("setup_s") == 3.5
    assert r("frame_ms.p95") == pytest.approx(11.0)
    assert r("inference_core.launches_per_frame") == 1.5
    assert r("models.encode_ms") == pytest.approx(0.02)
    assert r("steps.memorize_ms") == pytest.approx(0.01)
    assert r("device.idle_pct") == pytest.approx(70.0)
    # two reads' bound over the 10 us of similarity_kernel
    assert r("radix_topk_readout_roofline") == pytest.approx(
        100 * 2 * 5.125196e-5 / 10e-6)
    total = 2 * 1e9 + 2 * (2e9 + 3_433_881_600) + 5e8
    assert r("frame_mfu") == pytest.approx(100 * total / (200e-6 * 6.7e13))
    # buckets: each read counts its own tokens and objects, and the network
    # its frame's object counts (an add frame segments 2, memorizes 3)
    run.traced_frames = [dict(kind="memory", event="add", objects=2,
                              reads=[[8100, 1], [3240, 1]], memorized=3,
                              consolidate=False, lt=0)]
    run.stage_flops = {2: {"encode": 1e9, "segment": 1.5e9, "memorize": 4e8},
                       3: {"encode": 1e9, "segment": 2e9, "memorize": 5e8}}
    reads = [flops.read_ops(1620, n, 64, 30, 1, 256) for n in (8100, 3240)]
    assert r("frame_mfu") == pytest.approx(
        100 * (1e9 + 5e8 + 1.5e9 + sum(reads)) / (200e-6 * 6.7e13))
    bound = sum(flops.read_bound_s(o, flops.read_bytes(1620, n, 64, 1, 256), H100)
                for o, n in zip(reads, (8100, 3240)))
    assert r("radix_topk_readout_roofline") == pytest.approx(100 * bound / 10e-6)
    run.trace = None
    assert r("frame_mfu") is None and r("device.idle_pct") is None


def test_schedule_internal_size():
    assert schedule.internal_size(960, 1708, 480) == (480, 854)
    assert schedule.internal_size(480, 854, -1) == (480, 854)
