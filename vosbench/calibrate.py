"""The readings that the limits of `correct` are set from (not run by the
benchmark's own runs).

    python3 vosbench/calibrate.py --workload <name> --seeds 1,2,... \\
        [--seconds S] [--loop-frames N] [--loop-seeds K] [--out FILE]

For each seed, one run of the cell in this process (a window of the cell's
own load) and its check, with the control beside it: the reference at
TF32 in the program's place, one step from the same states, compared with
the reference at float32 and judged by check.verdict against the cell's
limits (control_correct). With --loop-frames, the first --loop-seeds seeds
also give the closed-loop witness: the program and the reference each
stream the first N frames of the first window video from their own state,
and each frame's mean |dp| and share of pixels whose argmax differs are
read (a witness for PERF.md, not a number `correct` compares). Prints one
JSON line a seed (with each kind's and each sampled frame's gaps), and
appends it to --out.
"""
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from vosbench import check, harness, spec as specs  # noqa: E402
from vosbench.events import Frame, Script  # noqa: E402
from vosbench.reference.stream import ReferenceStream  # noqa: E402
from vosbench.video import Stream, SyntheticVideo  # noqa: E402
from vosbench.weights import load_weights, make_weights  # noqa: E402


def loop_witness(spec: dict, workload: str, seed: int, frames: int,
                 device: str) -> dict:
    """The program and the reference, each from its own state, over the
    first `frames` frames of the first window video: [[t, mean |dp|,
    argmax mismatch share]] and the first frame whose masks differ."""
    import torch
    from cutie_tpu_torch.inference import InferenceCore
    from cutie_tpu_torch.utils.get_default_model import build_model

    wl = specs.workload(spec, workload)
    model_cfg = specs.config(spec, wl["config"])["model"]
    traffic = specs.traffic(wl["traffic"])
    cfg = harness.port_config(model_cfg, traffic["core"])
    dev = torch.device(device)
    with torch.device(dev):
        net = build_model(cfg, device=device)
    load_weights(net, make_weights(net, seed, dev))
    ref_net = check.build_reference(model_cfg, seed, dev)
    video = SyntheticVideo(traffic, seed)
    start = Stream(traffic["clip_frames"], int(traffic["warmup_frames"])).start(0)
    script = Script(traffic)
    setups = script.setup(specs.config(spec, wl["config"]), seed, dev)
    port, ref = InferenceCore(net, cfg), ReferenceStream(ref_net, traffic["core"])
    rows, parted = [], None
    for t in range(frames):
        i = start + t
        fr = Frame(video, i, t, setups)
        script.program(port, fr)
        p = fr.step(port)
        torch.backends.cudnn.benchmark = True
        fr = Frame(video, i, t, setups)
        script.reference(ref, fr)
        r = fr.step(ref)
        torch.backends.cudnn.benchmark = False
        mism = float((p.argmax(0) != r.argmax(0)).float().mean())
        rows.append([t, float((p.float() - r.float()).abs().mean()), mism])
        if parted is None and mism > 0:
            parted = t
    return {"loop": rows, "parted_at": parted}


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=None)
    parser.add_argument("--loop-frames", type=int, default=0)
    parser.add_argument("--loop-seeds", type=int, default=3)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    spec = specs.load_spec()
    seconds = args.seconds or spec["run_seconds"]
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        r = harness.run_cell(spec, args.workload, seed, seconds, False, "cuda",
                             t0, control=True)
        line = {"workload": args.workload, "seed": seed, "correct": r["correct"],
                "program": {k: v["value"] for k, v in r["check"].items()},
                "kinds": r["kinds"], "samples": r["samples"],
                "control": {k: v for k, v in r["control"].items() if k != "samples"},
                "control_correct": r["control_correct"],
                "metrics": r["metrics"],
                "device": r["device"], "seconds": time.time() - t0}
        if args.loop_frames and n < args.loop_seeds:
            line.update(loop_witness(spec, args.workload, seed, args.loop_frames,
                                     "cuda"))
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
