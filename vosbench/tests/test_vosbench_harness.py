"""A whole run on the CPU at a tiny size (the harness's look for a card
skipped): it is correct, it loads nothing of JAX or cutie_tpu, and it comes
out not correct when the timed path is broken underneath. Also the exits
without a card and outside a checkout."""
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from vosbench import harness, spec as specs

ROOT = Path(__file__).resolve().parents[2]
SPEC = specs.load_spec()


def tiny_events(traffic, clip):
    """The traffic's events with their positions scaled from its clip to
    `clip` frames ({} for a traffic without events)."""
    if "events" not in traffic:
        return {}
    scale = clip / traffic["clip_frames"]
    return {"events": [dict(ev, at=round(ev["at"] * scale))
                       for ev in traffic["events"]]}


def _overrides(workload):
    traffic = specs.traffic(specs.workload(SPEC, workload)["traffic"])
    # min_fps: a rate this CPU keeps at 64x96, so the window reaches every
    # sampled frame
    over = {"frame": [64, 96], "pool_frames": 8,
            "video": dict(traffic["video"], jitter_rows=8),
            "check": dict(traffic["check"], min_fps=15)}
    if traffic["clip_frames"] is None:
        core = dict(traffic["core"])
        core["long_term"] = dict(core["long_term"], num_prototypes=16,
                                 max_num_tokens=64, buffer_tokens=16)
        over.update(core=core, warmup_frames=30,
                    trace={"start_frame": 2, "frames": 6})
    elif "events" in traffic:
        # events at 0, 2, 4 and 13 of 16; the traced frames in the second clip
        over.update(clip_frames=16, warmup_frames=16,
                    trace={"start_frame": 24, "frames": 4},
                    **tiny_events(traffic, 16))
    else:
        # the traced frames in the second clip, as in the d17 traffic
        over.update(clip_frames=12, warmup_frames=12,
                    trace={"start_frame": 14, "frames": 6})
    return over


def _run(workload, seconds=3.0, hook=None, trace=False):
    torch.set_num_threads(2)
    return harness.run_cell(SPEC, workload, 2**33 + 5, seconds, trace, "cpu",
                            time.time(), traffic_overrides=_overrides(workload),
                            program_hook=hook)


def test_cpu_run_is_correct():
    r = _run("base.d17")
    assert r["correct"], r["check"]
    assert list(r)[-1] == "check" and list(r)[:5] == [
        "correct", "attempted", "failed", "metrics", "device"]
    assert set(r["metrics"]) == {"fps", "frame_ms.p95", "setup_s"}
    assert r["attempted"] > 12 and r["failed"] == 0


def test_cpu_run_with_events_is_correct():
    """Objects added and deleted: every kind of frame is checked, and the
    state after a deletion is the reference's to the bit."""
    r = _run("base.adddel720", seconds=6.0)
    assert r["correct"], r["check"]
    assert r["check"]["event_state_mismatch"]["value"] == 0


def test_cpu_long_term_run_is_correct():
    r = _run("base.lvos", seconds=4.0)
    assert r["correct"], r["check"]


def _memorize_unchanged(core):
    """Memory frames after the first leave the memory as it was."""
    memorize = core.steps.memorize

    def first_only(*a, mode, **k):
        if mode == "all":
            memorize(*a, mode=mode, **k)
    core.steps.memorize = first_only


def _half_the_queries_read_nothing(core):
    read = core.steps.read_memory

    def half(*a, **k):
        out = read(*a, **k)
        out[..., : out.shape[-2] // 2, :] = 0
        return out
    core.steps.read_memory = half


def _memory_values_altered(core):
    """Memory frames write their values 1% too large into the ring."""
    memorize = core.steps.memorize

    def altered(state, *a, mode, **k):
        memorize(state, *a, mode=mode, **k)
        if mode != "all":
            slot = (state.work_start + state.work_count - 1) % state.work_key.shape[1]
            state.work_value[:, :, slot] *= 1.01
    core.steps.memorize = altered


def _consolidation_altered(core):
    """Consolidation writes its prototypes' values 1% too large (the
    long-term memory's sizes as they should be)."""
    consolidate = core.steps.consolidate

    def altered(state, *a, **k):
        consolidate(state, *a, **k)
        n = core.steps.num_prototypes
        state.lt_value[:, :, state.lt_count - n:state.lt_count] *= 1.01
    core.steps.consolidate = altered


def _answer_altered(core):
    step = core.step

    def altered(*a, **k):
        prob = step(*a, **k).clone()
        # two objects' channels swapped; with one object, it and background
        swap = [1, 2] if prob.shape[0] > 2 else [0, 1]
        prob[swap] = prob[swap[::-1]]
        return prob
    core.step = altered


def _new_objects_not_permanent(core):
    """A mask's new objects join the working memory, as the others do,
    where they should get permanent memory of their own."""
    memorize = core.steps.memorize

    def ring_only(*a, mode, **k):
        memorize(*a, mode="no" if mode == "split" else mode, **k)
    core.steps.memorize = ring_only


def _one_read_for_all_buckets(core):
    """Every object reads the first bucket's tokens."""
    core._buckets = lambda: ((0,), torch.ones((1, core.state.num_objects)))


def _deletion_ignored(core):
    core.delete_objects = lambda objects: None


def _deletion_scrambled(core):
    """After a deletion the first two objects left hold each other's
    permanent values (shapes and counters as they should be)."""
    delete = core.delete_objects

    def scrambled(objects):
        delete(objects)
        v = core.state.perm_value
        v[:, [0, 1]] = v[:, [1, 0]].clone()
    core.delete_objects = scrambled


FAULTS = {"state_unchanged": _memorize_unchanged,
          "half_left_out": _half_the_queries_read_nothing,
          "answer_altered": _answer_altered,
          "memory_values_altered": _memory_values_altered,
          "consolidation_altered": _consolidation_altered,
          "new_objects_not_permanent": _new_objects_not_permanent,
          "one_read_for_all_buckets": _one_read_for_all_buckets,
          "deletion_ignored": _deletion_ignored,
          "deletion_scrambled": _deletion_scrambled}
EVENT_FAULTS = ("new_objects_not_permanent", "one_read_for_all_buckets",
                "deletion_ignored", "deletion_scrambled")


def _traffic_of(wl):
    return specs.traffic(specs.workload(SPEC, wl)["traffic"])


def _cell_can_have(fault, wl):
    if fault == "consolidation_altered":
        return _traffic_of(wl)["core"]["use_long_term"]
    if fault in EVENT_FAULTS:
        return "events" in _traffic_of(wl)
    return True


@pytest.mark.parametrize("fault,wl", [
    pytest.param(FAULTS[f], w["name"], id=f"{f}-{w['name']}")
    for f in FAULTS for w in SPEC["workloads"] if _cell_can_have(f, w["name"])])
def test_broken_timed_path_is_not_correct(fault, wl):
    """Each fault a one-card cell can have (no exchange between cards
    exists to leave out), and a fault of one kind of frame alone: memory
    frames' values, in long-term mode consolidation's prototypes, and where
    objects are added and deleted, the new bucket's permanent memory, the
    read a bucket and the deletion (left out, or its values moved wrong)."""
    # long enough for the window to reach the long-term mix's first
    # consolidation, or the deletion of the mix with events
    seconds = 4.0 if wl == "base.lvos" else 6.0 if "events" in _traffic_of(wl) else 3.0
    r = _run(wl, seconds=seconds, hook=fault)
    assert not r["correct"], r["check"]


def test_traced_cpu_run_reduces():
    r = _run("small.d17", seconds=3.0, trace=True)
    assert "breakdown" in r and r["device"]["window_s"] > 0
    assert "device.idle_pct" in r["metrics"]


def test_no_forbidden_module_in_a_run():
    code = (
        "import sys, time, torch; sys.path[0] = %r; torch.set_num_threads(2);"
        "from vosbench import harness, spec;"
        "from vosbench.tests.test_vosbench_harness import _overrides;"
        "s = spec.load_spec();"
        "harness.run_cell(s, 'small.d17', 3, 1.0, True, 'cpu', time.time(),"
        " traffic_overrides=_overrides('small.d17'));"
        "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout
    loaded = set(eval(out.strip().splitlines()[-1]))
    assert "cutie_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "cutie_tpu"}


def _cli(cwd):
    return subprocess.run(
        [sys.executable, "vosbench/run.py", "--workload", "base.d17", "--seed",
         str(2**31 + 11), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=cwd, timeout=300)


def test_no_card_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _cli(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_bare_directory_exits_without_a_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "vosbench", tmp_path / "vosbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    p = _cli(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("wl", [w["name"] for w in SPEC["workloads"]])
def test_cell_on_the_card(card, wl):
    """One short run of each cell on the card through the command line."""
    p = subprocess.run(
        [sys.executable, "vosbench/run.py", "--workload", wl, "--seed",
         str(2**32 + 17), "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
