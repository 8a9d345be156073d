"""Every configuration, workload and metric file loads, and
BENCHMARK.json names only what the harness finds by name."""

import json
import re

import pytest

from portbench import bench

SPEC = bench.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["portbench"]
    assert len(json.dumps(SPEC)) < 64 * 1024
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [c["name"] for c in SPEC["configs"]]
    names += [w["name"] for w in SPEC["workloads"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(m["name"] for m in SPEC["end_to_end"]
                   + SPEC["per_layer"])) == len(SPEC["end_to_end"]
                                                + SPEC["per_layer"])


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    body = json.loads((bench.ROOT / cfg["file"]).read_text())
    assert body["name"] == cfg["name"]
    assert body["reduced"] == cfg["reduced"]
    assert (bench.ROOT / body["scene"]).is_file()
    bench.load_module("roofline", body["roofline"])
    assert cfg["source"] in body["source"]


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_file(cell):
    wl = bench.load_json("workloads", cell["name"])
    for key in ("config", "traffic", "chips", "why"):
        assert wl[key] == cell[key], key
    assert len(cell["why"]) <= 200
    bench.load_json("configs", wl["config"])
    driver = bench.load_module("traffic", wl["traffic"])
    assert callable(driver.run)
    assert wl["limits"]
    assert cell["config"] in {c["name"] for c in SPEC["configs"]}
    kinds = {"end_to_end", "per_layer"}
    for kind in kinds:
        assert bench.cell_metrics(SPEC, cell["name"], kind), kind
    assert any(m["name"] == "setup_s"
               for m in bench.cell_metrics(SPEC, cell["name"], "end_to_end"))


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader(metric):
    reader = bench.load_module("metrics", metric["name"])
    assert callable(reader.read)
    assert UNIT.match(metric["unit"])
    assert metric["source"] in SOURCES
    assert metric["better"] in ("lower", "higher")
    assert reader.SOURCE == metric["source"]
    if "layer" in metric:
        assert reader.LAYER == metric["layer"]
        assert reader.MOVES == metric["moves"]
        moved = next(m for m in SPEC["end_to_end"]
                     if m["name"] == metric["moves"])
        for cell in metric["workloads"]:
            assert cell in moved.get("workloads", [cell])
    else:
        assert 0 < metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    for cell in metric.get("workloads", []):
        assert cell in {w["name"] for w in SPEC["workloads"]}


def test_four_chip_cells_within_share():
    cells = SPEC["workloads"]
    four = [w for w in cells if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4)
