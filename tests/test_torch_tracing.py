"""The port's spans (cutie_tpu_torch/utils/tracing.py) on the CPU: a small
long-term stream under torch.profiler opens every span of a frame, each in
its stated parent, one inference_core.step a frame; with no profiler
running the same stream enters no record_function; the flag the spans
check follows the profiler; chip_smoke.py's profiler sums leave out the
spans' device-side ranges."""
import contextlib
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401

from cutie_tpu_torch.config import eval_config  # noqa: E402
from cutie_tpu_torch.inference import InferenceCore  # noqa: E402
from cutie_tpu_torch.ops import read_kernel as rk  # noqa: E402
from cutie_tpu_torch.utils import tracing  # noqa: E402
from cutie_tpu_torch.utils.get_default_model import build_model  # noqa: E402

FRAMES = 12
# every span a CPU frame opens, and the span it nests in (None: none)
PARENT = {
    "inference_core.step": None,
    "inference_core.upload": "inference_core.step",
    "inference_core.merge_mask": "inference_core.step",
    "inference_core.to_host": None,
    "steps.encode": "inference_core.step",
    "steps.segment": "inference_core.step",
    "steps.read_memory": "steps.segment",
    "steps.memorize": "inference_core.step",
    "steps.consolidate": "inference_core.step",
    "models.pixel_encoder": "steps.encode",
    "models.key_projection": "steps.encode",
    "models.mask_encoder": "steps.memorize",
    "models.pixel_fusion": "steps.segment",
    "models.object_transformer": "steps.segment",
    "models.mask_decoder": "steps.segment",
}


def _stream(core, frames, masks):
    """Frame 0 brings object 1, frame 3 object 2 (a merge with the
    prediction); every frame's mask goes to the host."""
    for ti, frame in enumerate(frames):
        if ti in masks:
            prob = core.step(frame, masks[ti], objects=[1 if ti == 0 else 2])
        else:
            prob = core.step(frame)
        core.output_prob_to_mask(prob)


def _setup():
    """cutie-small at random weights, 48x80 frames, long-term mode with
    budgets so small that consolidation runs."""
    torch.manual_seed(0)
    cfg = eval_config("small")
    cfg.merge({"mem_every": 1, "top_k": 30, "stagger_updates": 5,
               "max_mem_frames": 3, "use_long_term": True,
               "long_term": {"count_usage": True, "max_mem_frames": 3,
                             "min_mem_frames": 1, "num_prototypes": 8,
                             "max_num_tokens": 64, "buffer_tokens": 16}})
    net = build_model(cfg, device="cpu")
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (FRAMES, 48, 80, 3), dtype=np.uint8)
    mask0 = np.zeros((48, 80), np.int64)
    mask0[8:30, 10:40] = 1
    mask3 = np.zeros((48, 80), np.int64)
    mask3[20:44, 45:75] = 2
    return net, cfg, frames, {0: mask0, 3: mask3}


@pytest.fixture(scope="module")
def traced():
    """The cutie.* spans of one profiled stream, [(name, start, end)] in
    start order, and the core."""
    net, cfg, frames, masks = _setup()
    core = InferenceCore(net, cfg)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _stream(core, frames, masks)
    spans = sorted(((e.name[len(tracing.PREFIX):], e.time_range.start,
                     e.time_range.end) for e in prof.events()
                    if e.name.startswith(tracing.PREFIX)),
                   key=lambda s: (s[1], -s[2]))
    return spans, core


def _parents(spans):
    """Each span's innermost enclosing span (None at the top)."""
    out, stack = [], []
    for name, start, end in spans:
        while stack and stack[-1][2] < end:
            stack.pop()
        out.append((name, stack[-1][0] if stack else None))
        stack.append((name, start, end))
    return out


def test_every_span_opens_and_the_read_kernel_span_only_on_the_card(traced):
    spans, core = traced
    assert core.consolidations > 0
    # the CPU read is the plain version, which opens no span
    assert {name for name, _, _ in spans} == set(PARENT)


def test_one_step_span_a_frame(traced):
    spans, _ = traced
    names = [name for name, _, _ in spans]
    assert names.count("inference_core.step") == FRAMES
    assert names.count("inference_core.to_host") == FRAMES
    # every frame but the first reads memory and segments
    assert names.count("steps.segment") == FRAMES - 1
    assert names.count("steps.read_memory") == FRAMES - 1
    assert names.count("inference_core.merge_mask") == 2


@pytest.mark.parametrize("name", sorted(PARENT))
def test_span_nests_in_its_parent(traced, name):
    spans, _ = traced
    parents = {p for n, p in _parents(spans) if n == name}
    assert parents == {PARENT[name]}


def test_no_record_function_without_a_profiler(monkeypatch):
    net, cfg, frames, masks = _setup()
    entered = []

    def counting(*args, **kwargs):
        entered.append(args)
        return contextlib.nullcontext()
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert not torch.autograd.profiler._is_profiler_enabled
    _stream(InferenceCore(net, cfg), frames, masks)
    assert entered == []
    assert tracing.span("steps.segment") is tracing.span("steps.encode")


def test_flag_follows_the_profiler():
    """The flag the spans check, torch.autograd.profiler's
    _is_profiler_enabled: True inside torch.profiler.profile, whether
    entered as a context or started and stopped, False outside; span
    follows it."""
    acts = [torch.profiler.ProfilerActivity.CPU]

    def on():
        return torch.autograd.profiler._is_profiler_enabled

    assert on() is False
    assert isinstance(tracing.span("x"), contextlib.nullcontext)
    with torch.profiler.profile(activities=acts):
        assert on() is True
        assert isinstance(tracing.span("x"), torch.profiler.record_function)
    assert on() is False
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        assert on() is True
    finally:
        prof.stop()
    assert on() is False
    assert isinstance(tracing.span("x"), contextlib.nullcontext)


class _FakeReadLibrary:
    """Stands in for the read kernel's library: every launch succeeds."""

    def radix_topk_readout_similarity_launch(self, *args):
        return 0

    def radix_topk_readout_select_launch(self, *args):
        return 0


def test_read_kernel_span_wraps_the_launches(monkeypatch):
    """The kernel's wrapper (checks, workspace, both stage launches) runs in
    read_kernel.radix_topk_readout; the library and the device are
    stand-ins, so the host side is what runs here."""
    monkeypatch.setattr(rk, "KERNEL_DEVICE", "cpu")
    monkeypatch.setattr(rk, "_library", lambda source: _FakeReadLibrary())
    monkeypatch.setattr(rk, "_on_device", lambda dev: contextlib.nullcontext(0))
    g = torch.Generator().manual_seed(0)
    n, p, ck, o, cv = 40, 8, 16, 2, 8
    args = (torch.randn(n, ck, generator=g), torch.rand(n, generator=g) + 1,
            torch.ones(n, dtype=torch.bool), torch.randn(p, ck, generator=g),
            torch.rand(p, ck, generator=g), torch.randn(o, n, cv, generator=g))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rk.radix_topk_readout_cuda(*args, 4)
        rk.radix_topk_readout_plain(*args, 4)
    names = [e.name for e in prof.events() if e.name.startswith(tracing.PREFIX)]
    assert names == ["cutie.read_kernel.radix_topk_readout"]


@pytest.mark.parametrize("device_type, annotation, counted", [
    ("CUDA", False, True), ("CUDA", True, False), ("CPU", False, False)])
def test_chip_smoke_sums_device_ops_not_span_ranges(device_type, annotation, counted):
    """Under a CUDA profiler a span is also a CUDA-typed gpu_user_annotation
    in key_averages(), timed as its range: chip_smoke.py's device time
    (kernel ms a frame, the profiled steps) counts kernels only."""
    import chip_smoke
    from torch.autograd import DeviceType
    ev = SimpleNamespace(device_type=getattr(DeviceType, device_type),
                         is_user_annotation=annotation, self_device_time_total=5.0)
    assert chip_smoke.is_device_op(ev) is counted
