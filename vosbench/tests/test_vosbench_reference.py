"""The plain reference against the port at a tiny size on the CPU, the
control against the limits, and the reference's imports."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from vosbench import check, schedule, spec as specs
from vosbench.events import Frame, Script
from vosbench.harness import port_config
from vosbench.reference.stream import ReferenceStream
from vosbench.video import SyntheticVideo
from vosbench.weights import load_weights, make_weights

SPEC = specs.load_spec()


def _core(traffic, **over):
    core = dict(specs.traffic(traffic)["core"], **over)
    if core["use_long_term"]:
        # budgets cut to a 48x80 frame (15 tokens), so that consolidation
        # and eviction both run within 60 frames
        core["long_term"] = dict(core["long_term"], num_prototypes=8,
                                 max_num_tokens=48, buffer_tokens=8)
    return core


def _small(traffic, hw):
    return dict(traffic, frame=list(hw), pool_frames=8,
                video=dict(traffic["video"], jitter_rows=8))


def _streams(core, frames, hw=(48, 80), config="cutie-small", seed=5):
    from cutie_tpu_torch.inference import InferenceCore
    from cutie_tpu_torch.utils.get_default_model import build_model

    model_cfg = specs.config(SPEC, config)["model"]
    cfg = port_config(model_cfg, core)
    net = build_model(cfg, device="cpu")
    load_weights(net, make_weights(net, seed, "cpu"))
    ref_net = check.build_reference(model_cfg, seed, "cpu")
    video = SyntheticVideo(_small(specs.traffic("d17"), hw), seed)
    port, ref = InferenceCore(net, cfg), ReferenceStream(ref_net, core)
    out = []
    for i in range(frames):
        args = (video.frame(i), video.mask(i), [1, 2, 3]) if i == 0 else (video.frame(i),)
        out.append((port.step(*args), ref.step(*args)))
    return out, port, ref


CASES = {
    "d17": (_core("d17"), 24),
    "plus720": (_core("plus720"), 24),
    "lvos_evicting": (_core("lvos", mem_every=2), 60),
    "d17_flip": (_core("d17", flip_aug=True), 12),
}


@pytest.mark.parametrize("case", CASES)
def test_reference_follows_the_port(case):
    core, frames = CASES[case]
    torch.set_num_threads(2)
    out, port, ref = _streams(core, frames)
    gaps = [float((p - r).abs().max()) for p, r in out]
    # float32 network on both sides; the port reads in float32 where the
    # reference reads in float64: a few float32 roundings of a probability
    assert max(gaps) < 2e-5, gaps
    assert port.consolidations == ref.consolidations
    if core["use_long_term"]:
        assert ref.consolidations >= 5


def test_reference_resizes_as_the_port():
    core = _core("d17", max_internal_size=32)
    out, _, _ = _streams(core, 8, hw=(64, 112))
    assert out[3][1].shape == (4, 64, 112)
    assert max(float((p - r).abs().max()) for p, r in out) < 2e-5


@pytest.mark.parametrize("wl", SPEC["workloads"], ids=lambda w: w["name"])
def test_control_fails_the_limits(wl):
    """The reference at TF32 (emulated on the CPU) in the program's place,
    one step from each state of a float32 reference stream over 16 frames
    of the cell's own settings and events (their positions scaled to the
    16 frames) at 64x96: a number has to exceed its limit."""
    from vosbench.tests.test_vosbench_harness import tiny_events

    traffic = dict(specs.traffic(wl["traffic"]), **tiny_events(
        specs.traffic(wl["traffic"]), 16))
    core = _core(wl["traffic"])
    model_cfg = specs.config(SPEC, wl["config"])["model"]
    video = SyntheticVideo(_small(traffic, (64, 96)), 11)
    script = Script(traffic)
    net = check.build_reference(model_cfg, 11, "cpu")
    torch.set_num_threads(2)
    stream, befores = ReferenceStream(net, core), []
    for i in range(16):
        befores.append(None if i == 0 else stream.export())
        fr = Frame(video, i, i, {})
        script.reference(stream, fr)
        fr.step(stream)
    steps = range(1, 16)
    tokens = schedule.tokens_per_frame(64, 96)
    kinds = [check.kind_of(f) for f in schedule.video_schedule(core, tokens, 16, script)]
    ref_out = {i: check.step_reference(net, core, script, Frame(video, i, i, {}),
                                       befores[i])
               for i in steps}
    with check.precision(net, "tf32"):
        ctl = [dict(i=i, kind=kinds[i], prob=p, after=a) for i in steps
               for p, a, _ in [check.step_reference(net, core, script,
                                                    Frame(video, i, i, {}), befores[i])]]
    correct, shown = check.verdict(check.compare(ctl, ref_out),
                                   specs.limits(wl["name"]))
    assert not correct, shown


def test_reference_imports_nothing_of_the_port():
    code = ("import sys, vosbench.reference.stream, vosbench.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & {"cutie_tpu_torch", "cutie_tpu", "jax", "jaxlib", "flax"}


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.0 - 2**-12, 2**-20])
    y = check._round_tf32(x)
    # ties go to even at 10 mantissa bits
    assert y.tolist() == [1.0, 1.0, 1.0 + 4 * 2**-11, -3.0, 2**-20]
    assert np.all(np.abs(check._round_tf32(torch.randn(1000)) .numpy()) >= 0)
