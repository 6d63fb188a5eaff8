"""BENCHMARK.json and the files it names: they parse, every name and unit
keeps to the allowed characters, and each cell, mix and metric finds its
file by its name."""
import json
import re

import pytest

from bench import harness

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"}


def line_ok(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(spec):
    assert set(spec) == TOP_KEYS
    assert spec["paths"] == ["bench"]
    assert spec["command"] == ["python3", "bench/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs(spec):
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["why"]) and line_ok(c["source"])
        assert c["file"] == f"bench/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in spec["workloads"])


def test_cells(spec):
    names = [w["name"] for w in spec["workloads"]]
    assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in spec["workloads"]}) == len(names)
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line_ok(w["why"])
        assert w["chips"] in (1, 4)
        traffic = harness.load_json(ROOT / "bench" / "traffic" / f"{w['traffic']}.json")
        assert (ROOT / "bench" / "kinds" / f"{traffic['kind']}.py").is_file()
        limits = harness.load_json(ROOT / "bench" / "workloads" / f"{w['name']}.json")["limits"]
        assert limits and all(v > 0 for v in limits.values())


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_metrics(spec, section):
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec[section]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        if section == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
            assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        else:
            assert m["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
            assert m["moves"] in e2e and line_ok(m["layer"])
            assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                              "workloads"}
            mod = harness.load_module(ROOT / "bench" / "metrics" / f"{m['name']}.py")
            assert callable(mod.read)
            if "roofline" in m["name"] or "mfu" in m["name"]:
                assert m["unit"] == "%"
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))


def test_every_cell_reports_enough(spec):
    for w in spec["workloads"]:
        e2e = harness.metrics_for(spec, "end_to_end", w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert harness.metrics_for(spec, "per_layer", w["name"])
        for m in harness.metrics_for(spec, "per_layer", w["name"]):
            assert m["moves"] in {e["name"] for e in e2e}


def test_check_budget(spec):
    """A full check of 24 cells fits into its 43,200 s at this run length."""
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (spec["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200
