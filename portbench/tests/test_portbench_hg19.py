"""The human paired-end deployment at tp = 4 (``hg19_p3.pe2x100``) in
small: a configuration in its layout (two sequences in chr1 : chr2's ratio,
about 1 Mbp, ``"tp": 4``) in a PE cell over four virtual CPU cards reads
correct, the cell's four readers (the merge span, the shards' row spread,
one shard's fallback share, the merged overflow share) give numbers there
and nothing in the one-card tiny cell or against a program without the
records, and every PE reader that reads the one-card cell reads the mesh
cell too."""

import json
import os
import shutil
import time

import pytest

from portbench import harness

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
CELL = "hg19_p3.pe2x100"
READERS = ("backend.decode_merge_s_per_mpair.pe",
           "mesh.shard_rows_imbalance.pe", "mesh.shard_fallback_share.pe",
           "mesh.merged_overflow_share.pe")
#: chr1 and chr2 of hg19, scaled to about 1 Mbp in all
HG19 = (249250621, 243199373)
TINY_LENGTHS = [round(1_000_000 * n / sum(HG19)) for n in HG19]


@pytest.fixture(scope="module")
def hg19_root(tiny_root, tmp_path_factory):
    """The tiny benchmark plus ``th.pe2x100``: the hg19 configuration with
    its genome cut to about 1 Mbp, on four virtual cards."""
    root = str(tmp_path_factory.mktemp("tiny_hg19") / "root")
    shutil.copytree(tiny_root, root)
    with open(os.path.join(REPO, "portbench", "configs",
                           "hg19_p3.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny_hg19"
    cfg["genome"].update(lengths=TINY_LENGTHS)
    path = "portbench/configs/tiny_hg19.json"
    with open(os.path.join(root, path), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append(dict(name="tiny_hg19", source="tiny", file=path,
                                reduced=[], why="CPU tests"))
    spec["workloads"].append(dict(name="th.pe2x100", config="tiny_hg19",
                                  traffic="tiny_pe2x100", chips=4,
                                  why="CPU tests"))
    for m in spec["per_layer"]:
        if "t.pe2x100" in m.get("workloads", []):
            m["workloads"].append("th.pe2x100")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


def _run(root, cell, trace):
    result, info = harness.run_cell(root, cell, 3141592653589, 1.0, trace,
                                    "cpu", time.perf_counter())
    return result, info


@pytest.fixture(scope="module")
def hg19_runs(hg19_root):
    return {trace: _run(hg19_root, "th.pe2x100", trace)
            for trace in (False, True)}


def test_the_configuration_keeps_hg19s_layout():
    with open(os.path.join(REPO, "portbench", "configs",
                           "hg19_p3.json")) as f:
        cfg = json.load(f)
    assert cfg["genome"]["names"] == ["chr1", "chr2"]
    assert tuple(cfg["genome"]["lengths"]) == HG19
    assert cfg["tp"] == 4 and cfg["seed_pattern"] == "3"
    assert cfg["flags"] == {"m": 6, "b": 5000, "k": 50, "L": 1000}
    assert TINY_LENGTHS[0] + TINY_LENGTHS[1] == 1_000_000


def test_entries_of_the_cell():
    """One four-card cell on the existing pe2x100 traffic, its
    configuration's cut named in ``reduced``, the four readers listing
    only it, and every other PE reader listing it after the one-card
    cell."""
    spec = harness.load_spec(REPO)
    cell, config, traffic = harness.find_cell(REPO, spec, CELL)
    assert cell["chips"] == 4 and cell["traffic"] == "pe2x100"
    assert harness.config_tp(config) == 4
    conf = next(c for c in spec["configs"] if c["name"] == "hg19_p3")
    assert conf["reduced"] == ["genome.names", "genome.lengths"]
    assert conf["source"] == config["source"]
    by_name = {m["name"]: m for m in spec["per_layer"]}
    for name in READERS:
        assert by_name[name]["workloads"] == [CELL], name
        assert by_name[name]["moves"] == "pairs_per_s"
    others = [m for m in spec["per_layer"] if m["name"] not in READERS]
    for m in others:
        if m["name"].endswith(".pe"):
            assert m["workloads"] == ["athal_p3.pe2x100", CELL], m["name"]
        else:
            assert CELL not in m.get("workloads", []), m["name"]
    e2e = {m["name"] for m in harness.cell_metrics(spec, CELL, "end_to_end")}
    assert e2e == {"pairs_per_s", "setup_s", "peak_device_gib"}


def test_tiny_hg19_cell_is_correct_on_four_cards(hg19_runs):
    for trace, (result, info) in hg19_runs.items():
        assert result["correct"], (trace, result["checked"])
        assert result["failed"] == 0 and result["attempted"] == info["fed"]
        assert info["mesh"] == {"dp": 1, "tp": 4}
    assert {"pairs_per_s", "setup_s"} <= set(hg19_runs[False][0]["metrics"])


def test_new_readers_read_the_mesh(hg19_runs):
    got = hg19_runs[True][0]["metrics"]
    assert set(READERS) <= set(got), sorted(set(READERS) - set(got))
    assert got["backend.decode_merge_s_per_mpair.pe"]["value"] > 0
    assert 1 <= got["mesh.shard_rows_imbalance.pe"]["value"] <= 4
    for name in ("mesh.shard_fallback_share.pe",
                 "mesh.merged_overflow_share.pe"):
        assert 0 <= got[name]["value"] <= 100, name
    # every mate is counted once: no shard flags more than were mapped
    assert (got["mesh.shard_fallback_share.pe"]["value"]
            + got["mesh.merged_overflow_share.pe"]["value"]) <= 100


@pytest.fixture(scope="module")
def one_card_traced(hg19_root):
    return _run(hg19_root, "t.pe2x100", True)[0]


def test_new_readers_read_nothing_on_one_card(one_card_traced):
    result = one_card_traced
    assert result["correct"], result["checked"]
    assert "driver.device_pair_share.pe" in result["metrics"]
    assert not set(READERS) & set(result["metrics"])


def test_pe_readers_read_the_mesh_as_one_card(hg19_runs, one_card_traced):
    """The PE readers that the mesh cell lists beside the one-card cell
    give a number on four cards wherever they give one on one card."""
    one = {k for k in one_card_traced["metrics"] if k.endswith(".pe")}
    assert len(one) >= 10, sorted(one)
    mesh = set(hg19_runs[True][0]["metrics"])
    assert one <= mesh, sorted(one - mesh)


def test_new_readers_report_nothing_without_records(monkeypatch):
    from walt_tpu_torch import perf

    monkeypatch.delattr(perf, "counters")
    run = dict(mode="pe", n=1000, window_s=1.0, setup_s=1.0, peak_bytes=0,
               spans={"backend.decode": 0.5}, trace=None)
    for name in READERS:
        assert harness.metric_reader(REPO, name)(run) is None, name
