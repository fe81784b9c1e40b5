"""The per-layer metrics that read the program's own spans and counters
(``walt_tpu_torch.perf``): a traced tiny PE run reports each of them, the
counted pair share is the one the driver's counters give for the pairs the
window fed, the window captures no graph, and against a program without
records or counters the readers report nothing and raise nothing."""

import json
import os
import time

import pytest

from portbench import harness

NEW = ("driver.parse_fill_s_per_mpair.pe", "driver.emit_prep_s_per_mpair.pe",
       "driver.map_wait_s_per_mpair.pe", "driver.main_offcpu_share.pe",
       "driver.batch_s_median.pe", "driver.device_pair_share.pe",
       "backend.pack_s_per_mpair.pe", "backend.sync_s_per_mpair.pe",
       "backend.decode_s_per_mpair.pe", "device.window_graph_captures.pe")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


@pytest.fixture(scope="module")
def traced(tiny_root):
    from walt_tpu_torch import perf

    result, info = harness.run_cell(tiny_root, "t.pe2x100", 98765432109, 2.0,
                                    True, "cpu", time.perf_counter())
    return result, info, perf.counters()


def test_traced_pe_run_reports_the_new_metrics(traced):
    result, info, _ = traced
    assert result["correct"], result["checked"]
    got = result["metrics"]
    assert set(NEW) <= set(got), sorted(set(NEW) - set(got))
    for name in NEW:
        assert got[name]["value"] >= 0, name
    assert 0 < got["driver.main_offcpu_share.pe"]["value"] < 100
    assert 0 < got["driver.batch_s_median.pe"]["value"] < info["window_s"]
    # the old span readers still read what they read before
    assert "driver.finalize_s_per_mpair.pe" in got
    assert info["batches"] >= 2


def test_counted_pair_share_reads_the_drivers_counters(traced):
    """Every pair the window fed reaches ``pe_finalize`` once, some go to
    the exact host path, and the share is the rest."""
    result, _, counters = traced
    pairs, host = counters["driver.pairs"], counters["driver.pairs_host"]
    assert pairs == result["attempted"]
    assert 0 < host < pairs
    assert (result["metrics"]["driver.device_pair_share.pe"]["value"]
            == 100.0 * ((pairs - host) / pairs))


def test_window_captures_no_graph(traced):
    """Every chunk shape of the window's batches was seen in warm-up."""
    result, info, _ = traced
    assert result["metrics"]["device.window_graph_captures.pe"]["value"] == 0
    assert info["graphs_before"] == info["graphs_after"]


def test_readers_report_nothing_without_records(monkeypatch):
    from walt_tpu_torch import perf

    monkeypatch.delattr(perf, "spans")
    monkeypatch.delattr(perf, "counters")
    run = dict(mode="pe", n=1000, window_s=1.0, setup_s=1.0, peak_bytes=0,
               spans={"host_parse": 0.5, "host_emit": 0.3},
               trace=None)
    for name in NEW:
        assert harness.metric_reader(REPO, name)(run) is None, name


def test_entries_read_the_pe_cell():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    by_name = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        m = by_name[name]
        assert m["workloads"] == ["athal_p3.pe2x100"], name
        assert m["moves"] == "pairs_per_s", name
        assert os.path.exists(os.path.join(REPO, "portbench", "metrics",
                                           name + ".py"))
