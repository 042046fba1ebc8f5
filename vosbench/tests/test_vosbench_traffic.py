"""The traffic generator and the memory schedule."""
import numpy as np
import pytest
import torch

from vosbench import schedule, spec as specs
from vosbench.video import Stream, SyntheticVideo

SPEC = specs.load_spec()

def _traffic(name, **over):
    t = specs.traffic(name)
    small = {"frame": [48, 80], "pool_frames": 6,
             "video": dict(t["video"], jitter_rows=8)}
    return dict(t, **dict(small, **over))


@pytest.mark.parametrize("name", ["d17", "plus720", "lvos"])
def test_video_repeats_by_seed(name):
    t = _traffic(name)
    a, b = SyntheticVideo(t, 2**40 + 7), SyntheticVideo(t, 2**40 + 7)
    c = SyntheticVideo(t, 2**40 + 8)
    assert np.array_equal(a.frames, b.frames) and np.array_equal(a.masks, b.masks)
    assert not np.array_equal(a.frames, c.frames)
    assert a.frames.shape == (6, 48 + 8, 80, 3) and a.frames.dtype == np.uint8
    # every object is in every frame, whatever the crop, and only objects
    # 1..n are drawn
    for i in range(40):
        assert a.frame(i).shape == (48, 80, 3) and a.frame(i).flags["C_CONTIGUOUS"]
        assert set(np.unique(a.mask(i))) == set(range(t["objects"] + 1))


def test_pool_plays_forward_and_back():
    v = SyntheticVideo(_traffic("d17"), 3)
    assert [v.index(i) for i in range(12)] == [0, 1, 2, 3, 4, 5, 4, 3, 2, 1, 0, 1]
    # a pool frame shown again is cropped one row lower: no frame repeats
    # within jitter_rows passes
    assert np.array_equal(v.frame(3)[1:], v.frame(7)[:-1])
    frames = {v.frame(i).tobytes() for i in range(8 * 5)}
    assert len(frames) == 8 * 5
    s = Stream(70)
    assert (s.video(139), s.position(139), s.start(2)) == (1, 69, 140)
    assert Stream(None).position(1000) == 1000


def test_full_memories():
    d17 = schedule.video_schedule(specs.traffic("d17")["core"], 1620, 70)
    assert max(f["read_tokens"] for f in d17) == 8100
    assert d17[21]["read_tokens"] == 1620 * 5 and d17[6]["read_tokens"] == 1620 * 2
    assert [f["kind"] for f in d17[:6]] == ["first"] + ["plain"] * 4 + ["memory"]
    p720 = schedule.video_schedule(specs.traffic("plus720")["core"], 3600, 70)
    assert max(f["read_tokens"] for f in p720) == 36000
    assert schedule.tokens_per_frame(720, 1280) == 3600
    assert schedule.tokens_per_frame(480, 854) == 1620


def test_long_term_schedule():
    lv = schedule.video_schedule(specs.traffic("lvos")["core"], 1620, 400)
    cons = [t for t, f in enumerate(lv) if f["consolidate"]]
    # the ring holds 9 frames at frame 45, then gains 5 every 25 frames
    assert cons[:4] == [45, 70, 95, 120]
    assert [lv[t + 1]["lt"] for t in cons[:3]] == [128, 256, 384]
    # the read after the first consolidation: perm, 4 ring frames, 128
    assert lv[46]["read_tokens"] == 1620 * 5 + 128


def _port_tokens(core, frames, h, w):
    """The valid tokens the port's state holds before each frame."""
    from cutie_tpu_torch.inference import InferenceCore
    from vosbench.harness import port_config

    torch.manual_seed(0)
    cfg = port_config(specs.config(specs.load_spec(), "cutie-small")["model"], core)
    from cutie_tpu_torch.utils.get_default_model import build_model
    net = build_model(cfg, device="cpu")
    t = _traffic("d17", frame=[h, w], pool_frames=4)
    v = SyntheticVideo(t, 1)
    c = InferenceCore(net, cfg)
    out = []
    for i in range(frames):
        st = c.state
        out.append(0 if st is None else
                   st.perm_n + st.work_count * (h // 16) * (w // 16) + st.lt_count)
        c.step(v.frame(i), v.mask(i), [1, 2, 3]) if i == 0 else c.step(v.frame(i))
    return out


def test_schedule_matches_the_port():
    core = dict(specs.traffic("lvos")["core"])
    core["long_term"] = dict(core["long_term"], num_prototypes=8,
                             max_num_tokens=40, buffer_tokens=8)
    core["mem_every"] = 2
    frames = 60
    got = _port_tokens(core, frames, 32, 48)
    want = [f["read_tokens"] for f in schedule.video_schedule(core, 6, frames)]
    assert got[1:] == want[1:]


@pytest.mark.parametrize("wl", [w["name"] for w in SPEC["workloads"]])
def test_sample_plan_lies_within_reach(wl):
    """Every kind gets its count of checked frames, all of them inside the
    first min_fps x run_seconds window frames (which a run at min_fps
    reaches) and outside the traced sub-window."""
    from vosbench import check, harness

    traffic = specs.traffic(specs.workload(SPEC, wl)["traffic"])
    seconds = SPEC["run_seconds"]
    stream = Stream(traffic["clip_frames"], int(traffic["warmup_frames"]))
    horizon = (int(traffic["warmup_frames"]) + int(traffic["check"]["min_fps"] * seconds)
               + (stream.clip_frames or 0))
    for seed in (1, 2**40 + 3):
        plan = check.SamplePlan(traffic, stream, seed, seconds,
                                harness._frame_plan(traffic, stream, horizon))
        counts = {k: list(plan.kinds.values()).count(k) for k in set(plan.kinds.values())}
        assert counts == traffic["check"]["per_kind"]
        # a position's window frame: in the first window clip, or in the video
        offset = 0 if stream.clip_frames is not None else int(traffic["warmup_frames"])
        start = int(traffic["trace"]["start_frame"])
        for pos, kind in plan.kinds.items():
            if kind == "first":
                continue
            t = pos - offset
            assert 0 <= t < plan.reach
            assert not start <= t < start + int(traffic["trace"]["frames"])
