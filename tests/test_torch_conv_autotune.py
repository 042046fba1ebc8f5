"""cuDNN times its convolution algorithms inside InferenceCore.step
(cutie_tpu_torch/inference/inference_core.py:cudnn_timing), on the CPU:

- every network call of a step sees torch.backends.cudnn.benchmark True,
  on first, plain, memory and long-term consolidation frames, in fp32,
  with flip_aug and with amp, and TF32 off in cuDNN and in matmuls;
- the caller's flag is back after each step, whether it was False or
  True, and also when the step raises;
- cudnn_timing.steps rises by exactly one a step on a CUDA device, and
  not on the CPU, where cuDNN times nothing;
- with the read sharded over two ranks (gloo on the CPU) the step leaves
  the caller's flag as it was: each rank's network has to compute the
  same bits, which timing in each process apart would not promise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests import torch_parallel_ranks as ranks  # noqa: E402
from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401

from cutie_tpu_torch.config import eval_config  # noqa: E402
from cutie_tpu_torch.inference import InferenceCore  # noqa: E402
from cutie_tpu_torch.inference.inference_core import cudnn_timing  # noqa: E402
from cutie_tpu_torch.parallel.launch import spawn_ranks  # noqa: E402
from cutie_tpu_torch.utils.get_default_model import build_model  # noqa: E402

FRAMES = 14
MODULES = ("pixel_encoder", "mask_decoder", "mask_encoder")
# the network modules each kind of frame runs, and whether it consolidates
RUNS = {
    "first": {"pixel_encoder", "mask_encoder"},
    "plain": {"pixel_encoder", "mask_decoder"},
    "memory": {"pixel_encoder", "mask_decoder", "mask_encoder"},
    "consolidation": {"pixel_encoder", "mask_decoder", "mask_encoder",
                      "consolidate"},
}
VARIANTS = {"fp32": {}, "flip_aug": {"flip_aug": True}, "amp": {"amp": True}}


def _flags():
    return (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def _setup(**extra):
    """cutie-small at random weights, 48x80 frames, a memory frame every
    3, long-term budgets so small that consolidation runs."""
    torch.manual_seed(0)
    cfg = eval_config("small")
    cfg.merge({"mem_every": 3, "top_k": 30, "stagger_updates": 5,
               "max_mem_frames": 3, "use_long_term": True,
               "long_term": {"count_usage": True, "max_mem_frames": 3,
                             "min_mem_frames": 1, "num_prototypes": 8,
                             "max_num_tokens": 64, "buffer_tokens": 16},
               **extra})
    net = build_model(cfg, device="cpu")
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (FRAMES, 48, 80, 3), dtype=np.uint8)
    mask = np.zeros((48, 80), np.int64)
    mask[8:30, 10:40] = 1
    return net, cfg, frames, mask


def _record(net, core, calls):
    """Append (name, flags) to calls at every forward of MODULES and at
    every consolidation; returns the hook handles."""
    handles = [getattr(net, name).register_forward_pre_hook(
        lambda m, args, name=name: calls.append((name, _flags())))
        for name in MODULES]
    consolidate = core.steps.consolidate

    def recorded(*args, **kwargs):
        calls.append(("consolidate", _flags()))
        return consolidate(*args, **kwargs)

    core.steps.consolidate = recorded
    return handles


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def stream(request):
    """One stream with the caller's flag False: per step, its kind, the
    modules' and consolidation's flags inside, the flags after it and the
    counter's rise."""
    net, cfg, frames, mask = _setup(**VARIANTS[request.param])
    core = InferenceCore(net, cfg)
    calls = []
    handles = _record(net, core, calls)
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    steps = []
    try:
        for ti, frame in enumerate(frames):
            calls.clear()
            before = (cudnn_timing.steps, core.consolidations)
            if ti == 0:
                core.step(frame, mask, objects=[1])
            else:
                core.step(frame)
            if ti == 0:
                kind = "first"
            elif core.consolidations > before[1]:
                kind = "consolidation"
            elif core.last_mem_ti == core.curr_ti:
                kind = "memory"
            else:
                kind = "plain"
            steps.append(dict(kind=kind, calls=list(calls), after=_flags(),
                              counted=cudnn_timing.steps - before[0]))
    finally:
        torch.backends.cudnn.benchmark = saved
        for h in handles:
            h.remove()
    return request.param, steps


@pytest.mark.parametrize("kind", sorted(RUNS))
def test_every_network_call_of_a_step_times_convolutions(stream, kind):
    _, steps = stream
    of_kind = [s for s in steps if s["kind"] == kind]
    assert of_kind, f"the stream has no {kind} frame"
    for s in of_kind:
        assert {name for name, _ in s["calls"]} == RUNS[kind]
        assert all(flags[0] for _, flags in s["calls"]), s["calls"]


def test_tf32_stays_off_inside_the_step(stream):
    _, steps = stream
    calls = [flags for s in steps for _, flags in s["calls"]]
    assert calls
    assert not any(cudnn or matmul for _, cudnn, matmul in calls)


def test_the_flag_is_back_after_every_step(stream):
    _, steps = stream
    assert all(s["after"] == (False, False, False) for s in steps)


def test_the_counter_rises_by_one_a_step(stream):
    """Not on the CPU; one an entry on a CUDA device, none where off."""
    _, steps = stream
    assert [s["counted"] for s in steps] == [0] * FRAMES
    count = cudnn_timing.steps
    for on in (True, True, False):
        with cudnn_timing(torch.device("cuda"), on=on):
            pass
    assert cudnn_timing.steps == count + 2


@pytest.mark.parametrize("callers", [False, True])
def test_the_callers_flag_is_restored(callers):
    net, cfg, frames, mask = _setup()
    core = InferenceCore(net, cfg)
    calls = []
    handles = _record(net, core, calls)
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = callers
    try:
        core.step(frames[0], mask, objects=[1])
        assert torch.backends.cudnn.benchmark is callers
        core.step(frames[1])
        assert torch.backends.cudnn.benchmark is callers
    finally:
        torch.backends.cudnn.benchmark = saved
        for h in handles:
            h.remove()
    assert calls and all(flags[0] for _, flags in calls)


class _Raised(Exception):
    pass


@pytest.mark.parametrize("callers", [False, True])
def test_the_callers_flag_is_restored_when_the_step_raises(callers):
    net, cfg, frames, mask = _setup()
    core = InferenceCore(net, cfg)
    seen = []

    def fail(module, args):
        seen.append(torch.backends.cudnn.benchmark)
        raise _Raised

    handle = net.mask_encoder.register_forward_pre_hook(fail)
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = callers
    try:
        count = cudnn_timing.steps
        with pytest.raises(_Raised):
            core.step(frames[0], mask, objects=[1])
        assert torch.backends.cudnn.benchmark is callers
        assert cudnn_timing.steps == count
    finally:
        torch.backends.cudnn.benchmark = saved
        handle.remove()
    assert seen == [True]


def test_a_mesh_of_ranks_keeps_the_callers_flag():
    for res in spawn_ranks(ranks.rank_conv_timing, 2, threads=1, timeout=300):
        assert len(res["seen"]) >= 8 and not any(res["seen"]), res["seen"]
        assert res["after"] is False and res["counted"] == 0
