"""``driver.parse_copy_ratio.pe``, the reader of the FASTQ fill's copy
counters: a traced tiny PE run reports it between 1 and 2 (each stream
byte lands in a parse buffer about once), and against a program without
the counters it reports nothing and raises nothing."""

import json
import os
import time

import pytest

from portbench import harness

NAME = "driver.parse_copy_ratio.pe"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


@pytest.fixture(scope="module")
def traced(tiny_root):
    return harness.run_cell(tiny_root, "t.pe2x100", 98765432119, 2.0, True,
                            "cpu", time.perf_counter())


def test_traced_pe_run_reports_the_copy_ratio(traced):
    result, info = traced
    assert result["correct"], result["checked"]
    assert info["batches"] >= 2
    assert 1.0 <= result["metrics"][NAME]["value"] <= 2.0


@pytest.mark.parametrize("counters", [None, {}, {"parse.stream_bytes": 0}],
                         ids=["no_counters", "none_counted", "nothing_read"])
def test_reader_reports_nothing_without_the_counters(monkeypatch, counters):
    from walt_tpu_torch import perf

    if counters is None:
        monkeypatch.delattr(perf, "counters")
    else:
        monkeypatch.setattr(perf, "counters", lambda: dict(counters))
    run = dict(mode="pe", n=1000, window_s=1.0, setup_s=1.0, peak_bytes=0,
               spans={}, trace=None)
    assert harness.metric_reader(REPO, NAME)(run) is None
    assert harness.metric_reader(REPO, NAME)(dict(run, mode="se")) is None


def test_entry_reads_the_pe_cell():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    m = next(m for m in spec["per_layer"] if m["name"] == NAME)
    assert m["workloads"] == ["athal_p3.pe2x100"]
    assert (m["moves"], m["source"], m["layer"]) == (
        "pairs_per_s", "program_counter", "driver")
