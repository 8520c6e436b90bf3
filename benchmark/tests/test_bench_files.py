"""Every file BENCHMARK.json names loads and is named as it says."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][0] == "python3"
    for word in BENCH["command"][1:]:
        assert any(word.startswith(p + "/") for p in BENCH["paths"])
        assert (ROOT / word).is_file()
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_bounds():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"time_to_solution_s", "peak_mem_gib", "setup_s"}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"]
    assert data["source"] == cfg["source"] and len(cfg["source"]) <= 200
    assert (ROOT / "benchmark" / "matrices" / f"{data['recipe']}.py").is_file()
    assert (ROOT / "benchmark" / "reference" / f"{data['reference']}.py").is_file()
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_and_metrics(name):
    cell = harness.load_cell(name, BENCH)
    w = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert cell.traffic["name"] == w["traffic"] and cell.config["name"] == w["config"]
    assert w["chips"] == 1 and len(w["why"]) <= 200
    assert cell.limits and set(cell.limits) <= {"eig_err", "vec_err"}
    assert set(cell.traffic["precision"]) == {"eigs", "vectors"}
    assert [m["name"] for m in cell.end_to_end] == [
        "time_to_solution_s", "peak_mem_gib", "setup_s"]
    per = {m["name"] for m in cell.per_layer}
    assert {"restarts", "stage_route_s", "stage_probe_s", "stage_solve_s",
            "device_idle"} <= per
    assert ("stage_polish_s" in per) == (cell.traffic["polish"] > 0)
    assert ("k1_roofline" in per) == (cell.config["route"].get("prefer") == "dia")


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader(metric):
    mod = harness.load_module(ROOT / "benchmark" / "metrics" / f"{metric['name']}.py")
    assert callable(mod.read)
