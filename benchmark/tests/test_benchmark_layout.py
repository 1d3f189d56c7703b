"""BENCHMARK.json against the contract, and every file found by its name."""

import json
import os
import re

import pytest

from cpu_cells import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCHMARK = json.load(f)
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    assert BENCHMARK["command"] == ["python3", "benchmark/run.py"]
    assert BENCHMARK["paths"] == ["benchmark"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCHMARK["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_one_line_texts():
    entries = (BENCHMARK["configs"] + BENCHMARK["workloads"] + BENCHMARK["end_to_end"]
               + BENCHMARK["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCHMARK[group]]
        assert len(names) == len(set(names))
    for w in BENCHMARK["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)


def test_entry_keys():
    for c in BENCHMARK["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
    for w in BENCHMARK["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCHMARK["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCHMARK["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    from cpu_cells import find
    c = find(cell)
    assert c.config["name"] == c.entry["config"]
    assert os.path.exists(os.path.join(BENCH, "traffic", f"{c.kind}.py"))
    assert set(c.params["limits"]) and all(v > 0 for v in c.params["limits"].values())
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


def test_per_layer_metrics_read_and_move_a_reported_metric():
    e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    for m in BENCHMARK["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", f"{m['name']}.py"))
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)


def test_layers_are_named_in_perf_md():
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    for m in BENCHMARK["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]


def test_config_files_are_the_options_the_program_takes():
    from envidr_tpu_torch.config import load_options
    for c in BENCHMARK["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        opts = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["options"].items()}
        load_options("", **opts)           # every key is an option of the program
        assert cfg["reduced"] == c["reduced"]
