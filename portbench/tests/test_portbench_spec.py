"""BENCHMARK.json against the benchmark's contract: keys, names, units,
bounds, the cells' metrics and the files the harness finds by name."""

import json
import os
import re

import pytest

from portbench import harness

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 << 10
    assert 1 <= spec["run_seconds"] <= 51
    assert isinstance(spec["run_seconds"], int)
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
    assert 1 <= len(spec["command"]) <= 32
    for w in spec["command"]:
        assert LINE.match(w)
        if "/" in w:
            assert any(w.startswith(p + "/") for p in spec["paths"]), w


def test_names_and_units(spec):
    seen = set()
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in spec[kind]:
            assert NAME.match(e["name"]), e["name"]
            assert (kind, e["name"]) not in seen
            seen.add((kind, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert LINE.match(e[k]), (e["name"], k)
    for w in spec["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_metric_entries(spec):
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in spec["end_to_end"])


def test_every_cell_reports_enough(spec):
    for w in spec["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(spec, w["name"],
                                                       "end_to_end")}
        per = harness.cell_metrics(spec, w["name"], "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2 and per, w["name"]


def test_per_layer_moves_what_its_cells_report(spec):
    """Each per-layer metric moves one end-to-end metric, reported in
    every cell the per-layer metric lists."""
    for m in spec["per_layer"]:
        cells = m.get("workloads", [w["name"] for w in spec["workloads"]])
        for c in cells:
            names = {e["name"] for e in harness.cell_metrics(
                spec, c, "end_to_end")}
            assert m["moves"] in names, (m["name"], c)


def test_files_found_by_name(spec):
    for c in spec["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert c["file"].startswith("portbench/")
    for w in spec["workloads"]:
        harness.find_cell(REPO, spec, w["name"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.metric_reader(REPO, m["name"]))


def test_check_budget_fits(spec):
    """A full check of 24 cells at this run length fits 43,200 s."""
    rs = spec["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_four_chip_cells_are_few(spec):
    n4 = sum(w["chips"] == 4 for w in spec["workloads"])
    assert n4 <= max(1, len(spec["workloads"]) // 4)
