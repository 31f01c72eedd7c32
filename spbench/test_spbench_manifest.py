"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name.  CPU only:  python -m pytest spbench -q"""

import ast
import json
import math
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "spbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def _e2e_of(cell: str) -> set:
    return {m["name"] for m in BENCH["end_to_end"]
            if cell in m.get("workloads", [cell])}


def test_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["spbench"]
    assert BENCH["command"] == ["python3", "spbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # 24 cells at this length fit the check's 43,200 s
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("spbench/")
        assert (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    for kind in ("configs", "workloads"):
        got = [e["name"] for e in BENCH[kind]]
        assert len(got) == len(set(got))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_metrics():
    e2e = BENCH["end_to_end"]
    assert 1 <= len(e2e) <= 16
    by = {m["name"]: m for m in e2e}
    assert by["setup_s"]["bound"] == 0.25 and "workloads" not in by["setup_s"]
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_enough():
    cells = [w["name"] for w in BENCH["workloads"]]
    for cell in cells:
        got = _e2e_of(cell)
        assert "setup_s" in got and len(got) >= 2
        assert any(cell in m.get("workloads", [cell])
                   for m in BENCH["per_layer"])


def test_per_layer_moves_a_metric_its_cells_report():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"])
        for cell in m.get("workloads", sorted(cells)):
            assert cell in cells
            assert m["moves"] in _e2e_of(cell), (m["name"], cell)


def test_at_most_a_quarter_of_cells_on_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    entry = {w["name"]: w for w in BENCH["workloads"]}[cell]
    wl = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
    assert wl["name"] == cell and wl["config"] == entry["config"]
    assert wl["why"] == entry["why"] or _line(wl["why"])
    assert (HERE / "drivers" / f"{wl['driver']}.py").is_file()
    assert wl["limits"] and all(v >= 0 for v in wl["limits"].values())
    cfg_file = {c["name"]: c["file"] for c in BENCH["configs"]}[
        entry["config"]]
    cfg = json.loads((ROOT / cfg_file).read_text())
    assert cfg["name"] == entry["config"]
    assert (HERE / "operators" / f"{cfg['generator']}.py").is_file()
    assert cfg["n"] == math.prod(cfg["grid"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    path = HERE / "metrics" / f"{metric}.py"
    tree = ast.parse(path.read_text())
    assert any(isinstance(n, ast.FunctionDef) and n.name == "read"
               for n in tree.body)


def test_configs_state_their_cuts():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert all(k in cfg and k in cfg["assumed"] for k in cfg["reduced"])
        assert cfg["dtype"] == "float64" and cfg["tolerance"] <= 1e-10
