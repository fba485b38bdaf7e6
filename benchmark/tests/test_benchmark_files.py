"""Every cell, configuration and metric of BENCHMARK.json resolves to its
files, and the file keeps to its format's rules."""

import json
import os
import re

import pytest

from conftest import CELLS, ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1].startswith("benchmark/")
    assert os.path.exists(os.path.join(ROOT, BENCH["command"][1]))
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    from benchmark import harness

    c = harness.load_cell(cell, BENCH)
    assert c.chips == 1
    route = harness.route_module(c.traffic)
    assert callable(route.prepare) and callable(route.step) and callable(route.first_steps)
    assert set(harness.load_limits(cell)) == {"plan", "launches", "mix", "loss1", "grad1_median",
                                              "change"}
    assert {m["name"] for m in c.end_to_end} == {"train_samples_per_s", "setup_s"}
    # at least one per-layer metric, each moving an end-to-end metric the cell reports
    assert c.per_layer
    assert {m["moves"] for m in c.per_layer} <= {m["name"] for m in c.end_to_end}


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    path = os.path.join(ROOT, conf["file"])
    config = json.load(open(path))
    assert conf["file"].startswith("benchmark/configs/")
    assert config["name"] == conf["name"] and config["source"] == conf["source"]
    assert config["reduced"] == conf["reduced"] == []
    assert config["precision"] == "float32" and config["tf32"] is False


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader(metric):
    from benchmark import harness

    assert callable(harness.metric_reader(metric["name"]).read)
    assert metric["moves"] == "train_samples_per_s"
    assert set(metric["workloads"]) <= set(CELLS)


def test_names_and_bounds():
    names = ([c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert all(NAME.fullmatch(n) for n in names)
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_traffic_launches_name_the_ports_wrappers(cell):
    from benchmark import harness
    from pcgmix_tpu_torch.ops.build import launch_counts

    launches = harness.load_cell(cell, BENCH).traffic["launches"]
    assert set(launches) <= set(launch_counts())
    for v in launches.values():
        assert set(v) == {"per_step", "device_kernel"} and v["per_step"] >= 0
