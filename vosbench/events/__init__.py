"""Events: what a traffic file schedules at clip positions besides frames.

A traffic file's `events` is a list of {"at": position, "kind": name, ...}:
position is a frame of every video (clip position; the frame index of a
continuous video), and the other keys are the kind's own. Position 0 of a
video must carry an event that gives masks: it is the video's first frame.
A traffic file without `events` adds every drawn object at position 0.

Each kind of event is one module, vosbench/events/<kind>.py, found by
file name (as vosbench/spec.py:reader finds a metric), with

  program(core, event, frame)    acts on the port's InferenceCore before
                                 the step of its frame: calls it (delete)
                                 or gives the step a mask (frame.give);
                                 its time counts in the frame
  reference(stream, event, frame)
                                 the same on the plain reference stream
                                 (vosbench/reference/stream.py)
  schedule(memory, event)        how the objects and buckets change, on
                                 vosbench/schedule.py:Memory
  setup(config_file, seed, device)
                                 optional: built once in set-up, before the
                                 warm-up; frame.setup[kind] holds what it
                                 returns
  numbers(samples, reference_out)
                                 optional: more numbers for `correct`
                                 ({name: reading}); check.verdict judges
                                 each that the cell's limits file names

and nothing else of the benchmark needs to know the kind.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from vosbench.video import drawn_objects

EVENTS_DIR = Path(__file__).resolve().parent
_KINDS: Dict[str, object] = {}
HOOKS = ("program", "reference", "schedule")


def kind(name: str):
    """The module vosbench/events/<name>.py."""
    if name not in _KINDS:
        path = EVENTS_DIR / f"{name}.py"
        if not path.is_file():
            raise ValueError(f"no event kind {name!r} (no {path})")
        mod_spec = importlib.util.spec_from_file_location(
            "vosbench_event_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        missing = [h for h in HOOKS if not hasattr(mod, h)]
        if missing:
            raise ValueError(f"event kind {name!r} lacks {', '.join(missing)}")
        _KINDS[name] = mod
    return _KINDS[name]


class Frame:
    """One frame as the events see it: stream frame i of the video, at
    clip position `position`, and what the step of it is given."""

    def __init__(self, video, i: int, position: int, setup: dict):
        self.video, self.i, self.position, self.setup = video, i, position, setup
        self.image = video.frame(i)
        self.mask: Optional[np.ndarray] = None
        self.objects: Optional[List[int]] = None

    def objects_mask(self, objects: List[int]) -> np.ndarray:
        """The video's index mask of this frame with only `objects` in it."""
        mask = self.video.mask(self.i)
        if set(objects) >= set(range(1, self.video.num_objects + 1)):
            return mask
        return np.where(np.isin(mask, objects), mask, 0).astype(mask.dtype)

    def give(self, mask: np.ndarray, objects: List[int]) -> None:
        """Hand the step an index mask of `objects`; masks given by two
        events of one frame are merged, the later on top."""
        if self.mask is None:
            self.mask, self.objects = mask, list(objects)
            return
        self.mask = np.where(mask > 0, mask, self.mask)
        self.objects += [o for o in objects if o not in self.objects]

    def step(self, target):
        """target.step of this frame: InferenceCore or ReferenceStream."""
        if self.mask is None:
            return target.step(self.image)
        return target.step(self.image, self.mask, self.objects)


class Script:
    """The events of one traffic mix, by clip position."""

    def __init__(self, traffic: dict):
        drawn = drawn_objects(traffic)
        events = traffic.get("events")
        if events is None:
            events = [{"at": 0, "kind": "add",
                       "objects": list(range(1, drawn + 1))}]
        self.by_position: Dict[int, List[dict]] = {}
        for ev in events:
            at = ev["at"]
            if not isinstance(at, int) or at < 0:
                raise ValueError(f"an event's position must be a whole number "
                                 f">= 0: {ev}")
            for o in ev.get("objects", []):
                if not isinstance(o, int) or not 1 <= o <= drawn:
                    raise ValueError(f"event {ev} names object {o!r}; the "
                                     f"video draws objects 1..{drawn}")
            kind(ev["kind"])
            self.by_position.setdefault(at, []).append(ev)
        if 0 not in self.by_position:
            raise ValueError("no event at position 0: a video starts with a mask")
        self.kinds = sorted({ev["kind"] for ev in events})

    def at(self, position: int) -> List[dict]:
        return self.by_position.get(position, [])

    def name(self, position: int) -> Optional[str]:
        """The kind of frame the events at `position` make for the check
        (their kinds joined by '+'), or None."""
        evs = self.at(position)
        return "+".join(ev["kind"] for ev in evs) if evs else None

    def setup(self, config_file: dict, seed: int, device) -> dict:
        """{kind: its setup(...)} of every kind that has one."""
        return {k: kind(k).setup(config_file, seed, device)
                for k in self.kinds if hasattr(kind(k), "setup")}

    def program(self, core, frame: Frame) -> None:
        for ev in self.at(frame.position):
            kind(ev["kind"]).program(core, ev, frame)

    def reference(self, stream, frame: Frame) -> None:
        for ev in self.at(frame.position):
            kind(ev["kind"]).reference(stream, ev, frame)

    def schedule(self, memory, position: int) -> None:
        for ev in self.at(position):
            kind(ev["kind"]).schedule(memory, ev)

    def numbers(self, samples: List[dict], ref_out: dict) -> dict:
        out = {}
        for k in self.kinds:
            if hasattr(kind(k), "numbers"):
                out.update(kind(k).numbers(samples, ref_out))
        return out
