"""BENCHMARK.json and the files the harness finds by name: every cell's
configuration, traffic, workload file and driver, every metric's reader;
names, units and the other fields within the benchmark's contract."""

import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run as harness  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
HERE = ROOT / "portbench"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_and_units_use_the_allowed_characters():
    names = ([c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
             + [w["config"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]] + [m["name"] for m in METRICS]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    for name in names:
        assert NAME.fullmatch(name), name
    for m in METRICS:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in BENCH["configs"]] + [w["why"] for w in BENCH["workloads"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_by_name(cell):
    entry, config, traffic, workload = harness.cell_files(BENCH, cell)
    assert config["name"] == entry["config"]
    assert (HERE / "drivers" / f"{traffic['driver']}.py").is_file()
    assert set(workload["limits"]) and all(v > 0 for v in workload["limits"].values())
    reported = {m["name"] for m in harness.cell_metrics(BENCH, cell, False)}
    assert "setup_s" in reported and len(reported) >= 2
    assert harness.cell_metrics(BENCH, cell, True)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_file_is_under_paths_and_its_own(config):
    path = ROOT / config["file"]
    assert path.is_file() and config["file"].startswith("portbench/")
    data = json.loads(path.read_text())
    assert data["name"] == config["name"] and data["reduced"] == config["reduced"]
    assert (ROOT / data["weights"]).is_file()
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader_named_after_it(metric):
    reader = harness.load_module(HERE / "metrics" / f"{metric['name']}.py")
    assert callable(reader.read)
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "moves" in metric:
        e2e = {m["name"]: m for m in BENCH["end_to_end"]}
        assert metric["moves"] in e2e
        moved = set(e2e[metric["moves"]].get("workloads", cells))
        assert set(metric.get("workloads", cells)) <= moved


def test_layers_of_one_name_are_written_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    for a in layers:
        for b in layers:
            assert a == b or a.lower() != b.lower()


def test_a_roofline_or_mfu_share_is_in_percent():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"].split("."):
            assert m["unit"] == "%"
