"""The readings that the limits of a cell with click events are set from
(vosbench/calibrate.py with the click's own numbers beside Cutie's; not
run by the benchmark's own runs).

    python3 vosbench/calibrate_click.py --workload ritm.click720 \\
        --seeds 1,2,... [--seconds S] [--out FILE]

For each seed, one run of the cell in this process and its check, with
the control beside it: the reference at TF32 in the program's place, for
Cutie's steps (harness.run_cell's control) and for the clicks
(events/click.py:control_numbers), judged together by check.verdict
against the cell's limits (control_correct). Also each click's f-BRS
evaluations, drive exit and host reads over the whole run. Prints one
JSON line a seed and appends it to --out. Needs a CUDA device.
"""
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from vosbench import check, harness, spec as specs  # noqa: E402
from vosbench.events import kind  # noqa: E402


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=None)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("calibrate_click: needs a CUDA device", file=sys.stderr)
        return 2
    spec = specs.load_spec()
    seconds = args.seconds or spec["run_seconds"]
    limits = specs.limits(args.workload)
    click = kind("click")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        r = harness.run_cell(spec, args.workload, seed, seconds, False, "cuda",
                             t0, control=True)
        st = click._LAST[0]
        sampled = [{"i": row[0]} for row in r["samples"]]
        control = {k: v for k, v in r["control"].items() if k != "samples"}
        control.update(click.control_numbers(sampled))
        steps = [s for rec in st.records.values() for o in rec["objects"]
                 for s in o["steps"] if s["exit"] is not None]
        # clicks after an object's first whose previous probabilities hold a
        # pixel above 0.5: the zoom-in crops them
        zoomed = sum(float(prev["out"].max()) > 0.5 for rec in st.records.values()
                     for o in rec["objects"] for prev in o["steps"][:-1])
        line = {"workload": args.workload, "seed": seed, "correct": r["correct"],
                "program": {k: v["value"] for k, v in r["check"].items()},
                "kinds": r["kinds"], "samples": r["samples"],
                "control": control,
                "control_correct": check.verdict(control, limits)[0],
                "clicks": {"optimised": len(steps), "zoomed": zoomed,
                           "evals": [s["evals"] for s in steps],
                           "exits": [s["exit"] for s in steps],
                           "host_reads": [s["reads"] for s in steps]},
                # each optimised click: [f(start), f(program), best of the
                # reference's search, its exit confirmed], the program's
                # and the control's
                "brs_clicks": [c for _, cs in st.brs_clicks for c in cs],
                "control_brs_clicks": [c for _, cs in st.control_brs_clicks for c in cs],
                "metrics": r["metrics"], "device": r["device"],
                "seconds": time.time() - t0}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        st.records.clear()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
