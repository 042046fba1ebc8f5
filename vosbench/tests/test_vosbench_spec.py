"""BENCHMARK.json and the files it names."""
import json
import re

import pytest

from vosbench import spec as specs

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = specs.load_spec()


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["vosbench"]
    assert SPEC["command"] == ["python3", "vosbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_resolves(entry):
    from cutie_tpu_torch.config.config import model_base, model_small

    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    cfg = specs.config(SPEC, entry["name"])
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    published = {"cutie-base": model_base, "cutie-small": model_small}
    # nothing is cut: the file's model block is the published yaml's
    assert entry["reduced"] == []
    assert cfg["model"] == published[entry["name"]]().to_dict()


@pytest.mark.parametrize("wl", SPEC["workloads"], ids=lambda e: e["name"])
def test_workload_resolves(wl):
    assert set(wl) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(wl["name"]) and wl["chips"] == 1
    assert len(wl["why"]) <= 200
    specs.config(SPEC, wl["config"])
    traffic = specs.traffic(wl["traffic"])
    assert {"frame", "objects", "clip_frames", "warmup_frames", "core",
            "video", "trace", "check"} <= set(traffic)
    limits = specs.limits(wl["name"])
    assert limits["numbers"]
    e2e = [m["name"] for m in specs.metrics_for(SPEC, wl["name"], "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert specs.metrics_for(SPEC, wl["name"], "per_layer")


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_resolves(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(specs.reader(metric["name"]))
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        e2e = {m["name"] for m in SPEC["end_to_end"]}
        assert metric["moves"] in e2e and metric["layer"]


def test_names_unique_and_file_small():
    for kind in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[kind]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert len(json.dumps(SPEC)) < 64 * 1024
