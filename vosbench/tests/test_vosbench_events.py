"""Events (vosbench/events): the reference and the port agree step by step
on an add/delete stream; a kind of event plugs in as new files only; and
the four traffic files without events read as they did before events
existed."""
import json
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from vosbench import check, harness, schedule, spec as specs
from vosbench.events import Frame, Script
from vosbench.flops import peaks, stage_flops
from vosbench.reference.stream import ReferenceStream
from vosbench.video import Stream, SyntheticVideo
from vosbench.weights import load_weights, make_weights

ROOT = Path(__file__).resolve().parents[2]
SPEC = specs.load_spec()
BEFORE = json.loads((Path(__file__).parent / "readings_before_events.json").read_text())
ADD_DELETE = [{"at": 0, "kind": "add", "objects": [1]},
              {"at": 4, "kind": "add", "objects": [2]},
              {"at": 7, "kind": "add", "objects": [3]},
              {"at": 12, "kind": "delete", "objects": [1]},
              {"at": 15, "kind": "delete", "objects": [3]}]


def test_reference_follows_the_port_with_events():
    """cutie-small at 48x80, objects added at 4 and 7 and deleted at 12
    and 15: the reference steps each frame from the port's state before
    it, with its events, to the port's output and state after it; and the
    two streams, each on its own, stay as close."""
    from cutie_tpu_torch.inference import InferenceCore
    from cutie_tpu_torch.utils.get_default_model import build_model

    torch.set_num_threads(2)
    t = specs.traffic("adddel720")
    traffic = dict(t, frame=[48, 80], pool_frames=8, events=ADD_DELETE,
                   video=dict(t["video"], jitter_rows=8))
    core = traffic["core"]
    model_cfg = specs.config(SPEC, "cutie-small")["model"]
    cfg = harness.port_config(model_cfg, core)
    net = build_model(cfg, device="cpu")
    load_weights(net, make_weights(net, 5, "cpu"))
    ref_net = check.build_reference(model_cfg, 5, "cpu")
    video, script = SyntheticVideo(traffic, 5), Script(traffic)
    port, ref = InferenceCore(net, cfg), ReferenceStream(ref_net, core)
    shapes = []
    for i in range(20):
        fr = Frame(video, i, i, {})
        before = check.port_state(port)
        script.program(port, fr)
        p = fr.step(port)
        after = check.port_state(port)
        one, one_after, _ = check.step_reference(ref_net, core, script,
                                                 Frame(video, i, i, {}), before)
        fr = Frame(video, i, i, {})
        script.reference(ref, fr)
        r = fr.step(ref)
        assert p.shape == one.shape == r.shape
        # float32 networks on both sides; the port reads in float32 where
        # the reference reads in float64
        assert float((p - one).abs().max()) < 2e-5
        assert float((p - r).abs().max()) < 2e-5
        assert check.state_gap(after, one_after) < 1e-4
        assert check.state_gap(after, ref.export()) < 1e-4
        shapes.append([len(b["objects"]) for b in after["buckets"]])
    # a bucket a mask of new objects; deletion drops an emptied bucket
    assert shapes[0] == [1] and shapes[4] == [1, 1] and shapes[7] == [1, 1, 1]
    assert shapes[12] == [1, 1] and shapes[15] == [1] and after["objects"] == [2]


TOY = '''"""recommit: the named objects' masks given again (a user's correction),
no new object: the step is not segmented, and the frame is memorized."""


def setup(config_file, seed, device):
    return {"commits": 0}


def program(core, event, frame):
    frame.setup["recommit"]["commits"] += 1
    frame.give(frame.objects_mask(event["objects"]), event["objects"])


def reference(stream, event, frame):
    frame.give(frame.objects_mask(event["objects"]), event["objects"])


def schedule(memory, event):
    memory.mask(event["objects"])


def numbers(samples, reference_out):
    gaps = [float((s["prob"] - reference_out[s["i"]][0]).abs().max())
            for s in samples if s["kind"] == "recommit"]
    return {"recommit_gap": max(gaps) if gaps else None}
'''


def test_a_kind_plugs_in_with_new_files_only(tmp_path):
    """A kind of event, its traffic mix, cell and limits, added as files
    and entries to a copy of the benchmark, run on the CPU with no edit to
    any file that is there: its frames are sampled and correct, and its
    own number is judged."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "vosbench", tmp_path / "vosbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = tmp_path / "vosbench"
    (bench / "events" / "recommit.py").write_text(TOY)
    t = specs.traffic("d17")
    toy = dict(t, frame=[64, 96], pool_frames=8, objects={"drawn": 2},
               video=dict(t["video"], jitter_rows=8), clip_frames=12,
               warmup_frames=12, trace={"start_frame": 20, "frames": 2},
               events=[{"at": 0, "kind": "add", "objects": [1, 2]},
                       {"at": 6, "kind": "recommit", "objects": [1]}],
               check=dict(t["check"], min_fps=15,
                          per_kind={"first": 1, "plain": 2, "recommit": 1}))
    (bench / "traffic" / "toy.json").write_text(json.dumps(toy))
    limits = specs.limits("small.d17")
    limits["numbers"]["recommit_gap"] = {"limit": 1e-4, "lower": None, "upper": None}
    (bench / "limits" / "small.toy.json").write_text(json.dumps(limits))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append(dict(specs.workload(SPEC, "small.d17"),
                                  name="small.toy", traffic="toy"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import json, sys, time, torch; sys.path[:0] = [%r, %r];"
        "torch.set_num_threads(2);"
        "from vosbench import harness, schedule, spec;"
        "from vosbench.events import Script;"
        "t = spec.traffic('toy');"
        "s = schedule.video_schedule(t['core'], 24, 12, Script(t));"
        "r = harness.run_cell(spec.load_spec(), 'small.toy', 3, 3.0, False, 'cpu',"
        " time.time(), control=True);"
        "print(json.dumps(dict(sched=s[6], check=r['check'], correct=r['correct'],"
        " kinds=r['kinds'], control=r['control_correct'])))" % (str(tmp_path), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    # a memory frame that reads nothing and memorizes both objects
    assert r["sched"]["event"] == "recommit" and r["sched"]["kind"] == "memory"
    assert r["sched"]["reads"] == [] and r["sched"]["memorized"] == 2
    assert 0 <= r["check"]["recommit_gap"]["value"] < 1e-4
    assert r["kinds"]["recommit"][2] >= 1
    assert r["correct"] and not r["control"], r


def test_a_traffic_with_events_stops_a_harness_without_them():
    """A harness that does not know events reads `objects` as a count: a
    traffic file with events stops it at once."""
    traffic = specs.traffic("adddel720")
    with pytest.raises(TypeError):
        int(traffic["objects"])
    with pytest.raises(ValueError):
        Script(dict(traffic, events=[e for e in traffic["events"] if e["at"]]))
    with pytest.raises(ValueError):
        Script(dict(traffic, events=traffic["events"] + [
            {"at": 9, "kind": "no_such_kind", "objects": [1]}]))
    with pytest.raises(ValueError):
        Script(dict(traffic, events=traffic["events"] + [
            {"at": 9, "kind": "add", "objects": [4]}]))


OLD_CELLS = [w for w in SPEC["workloads"]
             if "events" not in specs.traffic(w["traffic"])]


@pytest.mark.parametrize("name", ["d17", "plus720", "lvos"])
def test_schedule_as_before_events(name):
    t = specs.traffic(name)
    got = schedule.video_schedule(t["core"], schedule.tokens_per_frame(*t["frame"]),
                                  400, Script(t))
    want = BEFORE["schedules"][name]
    assert [[f["kind"], f["reads"][0][0] if f["reads"] else 0, f["consolidate"],
             f["lt"]] for f in got] == want
    n = t["objects"]
    for f, (kind, tokens, _, _) in zip(got, want):
        assert f["reads"] == ([[tokens, n]] if tokens else [])
        assert f["objects"] == (n if tokens else 0)
        assert f["memorized"] == (n if kind in ("first", "memory") else 0)
    assert got[0]["event"] == "add" and all(f["event"] is None for f in got[1:])


@pytest.mark.parametrize("wl", OLD_CELLS, ids=lambda w: w["name"])
def test_samples_operations_and_readings_as_before_events(wl):
    traffic = specs.traffic(wl["traffic"])
    before = BEFORE
    seconds = SPEC["run_seconds"]
    stream = Stream(traffic["clip_frames"], int(traffic["warmup_frames"]))
    script = Script(traffic)
    horizon = (int(traffic["warmup_frames"]) + int(traffic["check"]["min_fps"] * seconds)
               + (stream.clip_frames or 0))
    plan = harness._frame_plan(traffic, stream, horizon, script)
    for seed, want in before["plans"][wl["name"]].items():
        p = check.SamplePlan(traffic, stream, int(seed), seconds, plan)
        assert sorted([int(k), v] for k, v in p.kinds.items()) == want["kinds"]
        assert [i for i in range(horizon + 3 * (stream.clip_frames or 0))
                if p.wants(i)] == want["wants"]
    cfg = specs.config(SPEC, wl["config"])["model"]
    torch.set_num_threads(2)
    sf = stage_flops(check.build_reference(cfg, 7, "cpu"), 1, 3, 64, 96, "cpu")
    assert sf == before["stage_flops"][wl["name"]]
    trace_from = int(traffic["warmup_frames"]) + int(traffic["trace"]["start_frame"])
    trace_to = trace_from + int(traffic["trace"]["frames"])
    h, w = traffic["frame"]
    trace = SimpleNamespace(
        window_s=1.25, busy_s=0.5, span_count={"frame": trace_to - trace_from},
        launches=1000, span_device_s={},
        op_seconds={"similarity_kernel<1>": 0.01, "select_readout_kernel": 0.004,
                    "other": 0.3})
    run = SimpleNamespace(
        trace=trace, core=traffic["core"], model=cfg, batch=1,
        traced_frames=harness._frame_plan(traffic, stream, trace_to,
                                          script)[trace_from:trace_to],
        queries=-(-h // 16) * -(-w // 16), value_bytes=4,
        peak=peaks("NVIDIA H100 80GB HBM3"), stage_flops={3: sf})
    for m, v in before["per_layer"][wl["name"]].items():
        assert specs.reader(m)(run) == v, m
