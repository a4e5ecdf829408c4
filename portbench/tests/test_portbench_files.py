"""The benchmark's files: found by the names in BENCHMARK.json, and
named and shaped as the benchmark's contract asks."""

import json
import os
import re

import pytest

from portbench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = spec.benchmark()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(spec.ROOT, p))
    assert 1 <= len(BENCH["command"]) <= 32
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_found_by_name(cfg):
    assert NAME.match(cfg["name"])
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"].startswith(BENCH["paths"][0] + "/configs/")
    body = spec.load_json(os.path.join(spec.ROOT, cfg["file"]))
    assert body["name"] == cfg["name"]
    assert body["source"] == cfg["source"]
    assert sorted(body["reduced"]) == sorted(cfg["reduced"])
    for key in cfg["reduced"]:
        assert NAME.match(key)
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_finds_its_config_mix_and_metrics(cell):
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    c = spec.Cell(cell["name"], BENCH)
    assert c.traffic["kind"] in ("classify", "build")
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
        assert callable(spec.metric_reader(m["name"]))


def test_pairs_of_config_and_traffic_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in BENCH[key]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_names_units_and_keys(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for w in m.get("workloads", []):
        assert w in {c["name"] for c in BENCH["workloads"]}


def test_every_traffic_and_metric_file_is_named_by_the_benchmark():
    bench_dir = spec.BENCH_DIR
    mixes = {w["traffic"] for w in BENCH["workloads"]}
    metrics = {m["name"] for m in BENCH["per_layer"]}
    for f in os.listdir(os.path.join(bench_dir, "traffic")):
        assert f.endswith(".json") and NAME.match(f[:-5])
        json.load(open(os.path.join(bench_dir, "traffic", f)))
    for f in os.listdir(os.path.join(bench_dir, "metrics")):
        if f.endswith(".py"):
            assert f[:-3] in metrics, f
    assert mixes <= {f[:-5] for f in os.listdir(os.path.join(bench_dir,
                                                              "traffic"))}
