"""The traffic generator and the memory schedule."""
import numpy as np
import pytest
import torch

from vosbench import schedule, spec as specs
from vosbench.events import Script
from vosbench.video import Stream, SyntheticVideo, drawn_objects

SPEC = specs.load_spec()

def _traffic(name, **over):
    t = specs.traffic(name)
    small = {"frame": [48, 80], "pool_frames": 6,
             "video": dict(t["video"], jitter_rows=8)}
    return dict(t, **dict(small, **over))


@pytest.mark.parametrize("name", ["d17", "plus720", "lvos", "adddel720"])
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
        assert set(np.unique(a.mask(i))) == set(range(drawn_objects(t) + 1))


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


def _schedule(name, tokens, frames):
    t = specs.traffic(name)
    return schedule.video_schedule(t["core"], tokens, frames, Script(t))


def test_full_memories():
    d17 = _schedule("d17", 1620, 70)
    assert max(f["reads"] for f in d17) == [[8100, 3]]
    assert d17[21]["reads"] == [[1620 * 5, 3]] and d17[6]["reads"] == [[1620 * 2, 3]]
    assert [f["kind"] for f in d17[:6]] == ["first"] + ["plain"] * 4 + ["memory"]
    p720 = _schedule("plus720", 3600, 70)
    assert max(f["reads"] for f in p720) == [[36000, 3]]
    assert schedule.tokens_per_frame(720, 1280) == 3600
    assert schedule.tokens_per_frame(480, 854) == 1620


def test_long_term_schedule():
    lv = _schedule("lvos", 1620, 400)
    cons = [t for t, f in enumerate(lv) if f["consolidate"]]
    # the ring holds 9 frames at frame 45, then gains 5 every 25 frames
    assert cons[:4] == [45, 70, 95, 120]
    assert [lv[t + 1]["lt"] for t in cons[:3]] == [128, 256, 384]
    # the read after the first consolidation: perm, 4 ring frames, 128
    assert lv[46]["reads"] == [[1620 * 5 + 128, 3]]


def _port_reads(traffic, frames, h, w):
    """The reads the port makes at each frame, from its state before the
    step (after the frame's events): [valid tokens, objects] of each
    bucket, as StepFunctions.read_inputs takes them; [] where the frame is
    not segmented."""
    from cutie_tpu_torch.inference import InferenceCore
    from cutie_tpu_torch.utils.get_default_model import build_model
    from vosbench.events import Frame
    from vosbench.harness import port_config

    torch.manual_seed(0)
    core = traffic["core"]
    cfg = port_config(specs.config(specs.load_spec(), "cutie-small")["model"], core)
    net = build_model(cfg, device="cpu")
    t = dict(traffic, frame=[h, w], pool_frames=4,
             video=dict(traffic["video"], jitter_rows=8))
    v, script = SyntheticVideo(t, 1), Script(t)
    c = InferenceCore(net, cfg)
    hw = (h // 16) * (w // 16)
    out = []
    for i in range(frames):
        fr = Frame(v, i, i, {})
        script.program(c, fr)
        st = c.state
        reads = []
        segments = fr.mask is None or (
            c.object_manager.num_obj > 0 and not c.object_manager.has_all(fr.objects))
        if st is not None and segments:
            reps, sel = c._buckets()
            perm = torch.arange(st.perm_key.shape[1]) < st.perm_n
            for rep, s in zip(reps, sel):
                n = (int((perm & st.perm_obj_valid[rep]).sum())
                     + hw * int((st.ring_valid() & st.work_obj_valid[rep]).sum())
                     + int((st.lt_valid() & st.lt_obj_valid[rep]).sum()))
                reads.append([n, int(s.sum())])
        out.append(reads)
        fr.step(c)
    return out


def _lvos_evicting():
    t = specs.traffic("lvos")
    core = dict(t["core"], mem_every=2)
    core["long_term"] = dict(core["long_term"], num_prototypes=8,
                             max_num_tokens=40, buffer_tokens=8)
    return dict(t, core=core)


@pytest.mark.parametrize("traffic,frames", [
    pytest.param(_lvos_evicting(), 60, id="lvos_evicting"),
    pytest.param(specs.traffic("adddel720"), 130, id="adddel720")])
def test_schedule_matches_the_port(traffic, frames):
    """One read a bucket, each over the valid tokens of the port's memory
    and for the bucket's objects, at every frame: consolidation and
    eviction, and objects added (a bucket each) and deleted."""
    got = _port_reads(traffic, frames, 32, 48)
    want = [f["reads"] for f in schedule.video_schedule(
        traffic["core"], 6, frames, Script(traffic))]
    assert got == want
    assert max(len(r) for r in want) == (3 if "events" in traffic else 1)


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
                                harness._frame_plan(traffic, stream, horizon,
                                                    Script(traffic)))
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
