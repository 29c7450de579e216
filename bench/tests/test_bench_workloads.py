"""``BENCHMARK.json`` keeps its required form, and every cell resolves
by name to its configuration, traffic, check limits, runner and metric
readers."""
import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(SPEC["command"]) <= 32
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    n = len(SPEC["workloads"])
    assert 1 <= len(SPEC["configs"]) <= 24 and 1 <= n <= 24
    fours = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert fours <= max(1, n // 4)
    # 24 cells of 14 runs each (plus 2), each run_seconds + 60 s, 180 s a
    # cell to compile and 1200 s to spare fit in 12 hours
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_names_units_and_entries():
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == names
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    metric_names = [m["name"] for m in SPEC["end_to_end"]
                    + SPEC["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in SPEC["workloads"]}


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_resolves_by_name(cell):
    bench = ROOT / "bench"
    spec_cfg = next(c for c in SPEC["configs"] if c["name"] == cell["config"])
    cfg_file = bench / "configs" / f"{cell['config']}.json"
    assert spec_cfg["file"] == str(cfg_file.relative_to(ROOT))
    cfg = json.loads(cfg_file.read_text())
    assert cfg["name"] == cell["config"]
    assert cfg["source"] == spec_cfg["source"]
    for key in spec_cfg["reduced"]:
        assert key in cfg["reduced"] and key in cfg
    traffic = json.loads((bench / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    assert traffic["name"] == cell["traffic"]
    checks = json.loads((bench / "checks"
                         / f"{cell['name']}.json").read_text())
    assert checks["sample_rows"] > 0 and checks["limits"]
    runner = importlib.import_module(f"bench.runners.{cfg['runner']}")
    assert hasattr(runner, "Cell")
    # every cell reports setup_s, another end-to-end and a per-layer metric
    got = {g: [m["name"] for m in SPEC[g]
               if cell["name"] in m.get("workloads", [cell["name"]])]
           for g in ("end_to_end", "per_layer")}
    assert "setup_s" in got["end_to_end"] and len(got["end_to_end"]) >= 2
    assert got["per_layer"]
    for name in got["end_to_end"] + got["per_layer"]:
        assert callable(importlib.import_module(f"bench.metrics.{name}").read)
