"""tools/hg19_scale_torch.py at a toy size on the CPU: every stage runs,
the planned tp=2 and tp=4 meshes' outputs (100 and 150 bp reads, 2x100 and
2x150 bp pairs) and the CLI's (SE and PE) are byte-identical to the exact
host paths and to walt_tpu's CLI, the spilled tables are checked and
linked into the work directory, the pre-flight refuses a run that cannot
finish, and no report is written off the card."""

import json
import os
import subprocess
import sys

import pytest

from walt_tpu_torch.core.torch_backend import TorchBackend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_hg19_tool_rehearses_on_cpu(tmp_path):
    report = tmp_path / "report.json"
    env = dict(os.environ, WALTX_HG19_BP="1000000", WALTX_HG19_READS="500",
               WALTX_HG19_DIR=str(tmp_path / "work"),
               WALTX_HG19_REPORT=str(report))
    # 0.16 GiB above the backend's reserve holds neither rung of the toy
    # tables on one card (uniq 325 MB, key16 180 MB), nor the heavier tp=2
    # card with the uniq index (239 MB: the runtime's entry-balanced split
    # gives it 3/4 of each table's 4^12 buckets, whose arrays outweigh the
    # entries at this size), but that card with key16 (132 MB): the plan
    # splits them tp=2, key16 (memory decides here; the entry limit decides
    # hg19's tp=4 on an H100)
    hbm_gib = TorchBackend.HBM_RESERVE / 2**30 + 0.16
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "hg19_scale_torch.py"),
         "--device", "cpu", "--hbm-gib", f"{hbm_gib:.3f}"],
        env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    rep = json.loads(out.stdout)
    assert rep["parity"] == {"mr_bytes_equal": True,
                             "mapstats_bytes_equal": True}
    assert rep["mesh_map"]["tp"] == 2 and rep["mesh_map"]["virtual"]
    assert rep["mesh_map"]["accel"] == "key16"
    assert rep["plan"].startswith("0.00 Gbp x 2 tables: tp=2, key16")
    # the heavier of the two entry-balanced shards of a uniform genome's
    # C->T tables holds about half of their entries (walt_tpu's equal key
    # ranges would give it ~3/4: G and T)
    assert 0.49 < rep["heaviest_shard_entries"] / 1_000_000 < 0.51
    assert all(t["sha_ok"] for t in rep["round_trip"].values())
    assert len(rep["tables"]) == 4 and "card" not in rep
    assert not report.exists()
    assert "hg19-scale proof complete" in out.stderr


# ---- tp = 4, both read lengths, a spill directory --------------------------

TOY_BP = 1_000_000


def _tool(tmp, hbm_gib, *extra, **env):
    env = dict(os.environ, WALTX_HG19_BP=str(TOY_BP), WALTX_HG19_READS="500",
               WALTX_HG19_DIR=str(tmp / "work"),
               WALTX_HG19_REPORT=str(tmp / "report.json"), **env)
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "hg19_scale_torch.py"),
         "--device", "cpu", "--hbm-gib", f"{hbm_gib:.6f}", *extra],
        env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)


#: a toy shard's entry limit: 0.4 of a table, so that the limit refuses
#: tp=1 and tp=2 of the runtime's entry-balanced split (about half a table
#: per shard at tp=2) and leaves tp=4 (about a quarter), as the size-only
#: plan's model of walt_tpu's equal key ranges does for hg19 on an H100
#: (whose heavier tp=2 shard would hold ~0.71 of 3.1e9 entries, past 2^31)
TOY_ENTRY_LIMIT = 400_000


@pytest.fixture(scope="module")
def run_tp4(tmp_path_factory):
    """The tool at a toy size on an H100's memory with the toy entry limit,
    so both plans (SE's two tables, PE's four) pick tp=4 with the uniq rung
    as hg19's do: at this size no memory budget alone does (the tp=2 SE
    card is smaller than the tp=4 PE card).  GA10 and GA11 spilled."""
    from walt_tpu_torch import hbm_plan

    tmp = tmp_path_factory.mktemp("hg19_tp4")
    assert (hbm_plan.card_bytes(TOY_BP, 2, 2, False, 0.93)
            < hbm_plan.card_bytes(TOY_BP, 4, 4, False, 0.93))
    out = _tool(tmp, 79.1, "--spill-dir", str(tmp / "spill"),
                "--entry-limit", str(TOY_ENTRY_LIMIT))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout), tmp


def test_hg19_tool_tp4_spill_two_lengths(run_tp4):
    rep, tmp = run_tp4
    work, spill = tmp / "work", tmp / "spill"
    assert rep["plan"].startswith("0.00 Gbp x 2 tables: tp=4, uniq")
    assert rep["plan_pe"].startswith("0.00 Gbp x 4 tables: tp=4, uniq")
    assert rep["plan_entry_limit"] == TOY_ENTRY_LIMIT
    assert rep["heaviest_shard_entries_pe"] < TOY_ENTRY_LIMIT
    for mm in (rep["mesh_map"], rep["mesh_map_pe"]):
        assert (mm["tp"], mm["accel"], mm["virtual"]) == (4, "uniq", True)
        assert set(mm["by_length"]) == {"100", "150"}
    assert all(v["fallback_pct"] < 100
               for v in rep["mesh_map"]["by_length"].values())
    assert rep["mesh_map_pe"]["rungs"] == dict.fromkeys(
        ("CT00", "CT01", "GA10", "GA11"), "uniq")
    # both pair sets resolve most pairs on the (virtual) mesh, and no batch
    # went to the host after a device out-of-memory error
    for v in rep["mesh_map_pe"]["by_length"].values():
        assert v["pair_share"] > 0.5
        assert v["fallback_pairs"] == round(500 * (1 - v["pair_share"]))
    for run in (list(rep["mesh_map"]["by_length"].values())
                + list(rep["mesh_map_pe"]["by_length"].values())
                + [rep["cli_map"], rep["cli_map_pe"]]):
        assert run["degraded_batches"] == 0
    assert rep["failures"] == [] and rep["k1_launches"] == 0
    # the spilled tables were checked and stay in the spill directory,
    # linked into the work directory under the index's table names
    assert rep["spill"]["tables"] == ["GA10", "GA11"]
    assert rep["spill"]["links"] == ["hg19s.dbindex_GA10",
                                     "hg19s.dbindex_GA11"]
    assert rep["spill"]["peak_gib"] > 0
    assert sorted(p.name for p in spill.iterdir()) == rep["spill"]["links"]
    assert sorted(p.name for p in work.glob("hg19s.dbindex_*")) == [
        "hg19s.dbindex_CT00", "hg19s.dbindex_CT01", "hg19s.dbindex_GA10",
        "hg19s.dbindex_GA11"]
    for name in rep["spill"]["links"]:
        assert (work / name).is_symlink()
        assert (work / name).resolve() == (spill / name).resolve()
    assert all(t["sha_ok"] for t in rep["round_trip"].values())
    assert len(rep["round_trip"]) == 4
    assert {c: t["dir"] for c, t in rep["tables"].items()} == {
        "CT00": "work", "CT01": "work", "GA10": "spill", "GA11": "spill"}
    # every byte the tool wrote: the work directory's files (a link as
    # itself) and, the spill directory being on the same disk here, its
    # tables
    assert rep["disk_written_bytes"] == sum(
        p.lstat().st_size for p in list(work.rglob("*")) + list(
            spill.rglob("*")) if not p.is_dir())
    assert rep["disk_written_gib"] == round(rep["disk_written_bytes"] / 2**30,
                                            2)
    # host, mesh (both lengths) and CLI bytes are equal, SE and PE
    assert set(rep["parities"]) == {"mesh_100", "mesh_150", "cli_100",
                                    "mesh_pe_100", "mesh_pe_150",
                                    "cli_pe_100"}
    assert all(all(p.values()) for p in rep["parities"].values())
    assert rep["cli_map"]["rc"] == 0 and rep["cli_map_pe"]["rc"] == 0
    assert rep["cli_map_pe"]["flags"] == ["--tp", "4"]
    assert rep["host_map"]["100"]["unique"] > 0.9 * 500
    assert rep["host_map"]["150"]["unique"] > 0.9 * 500
    assert rep["host_map_pe"]["100"]["unique"] > 0.9 * 500
    assert rep["host_map_pe"]["150"]["unique"] > 0.8 * 500
    assert not (tmp / "report.json").exists()


def test_hg19_port_equals_walt_tpu_cli(run_tp4):
    """The port's SE and PE mesh and CLI outputs equal walt_tpu's CLI on its
    numpy backend (the host oracle) on the same index, reads and pairs;
    walt_tpu's CLI finds GA10 and GA11 through the work directory's
    links."""
    _, tmp = run_tp4
    work = tmp / "work"
    index = str(work / "hg19s.dbindex")
    runs = (
        (["-r", "reads.fastq"], ("out_mesh.mr", "out_cli.mr")),
        (["-r", "reads_150.fastq"], ("out_mesh_150.mr",)),
        (["-1", "reads_1.fastq", "-2", "reads_2.fastq"],
         ("out_mesh_pe.mr", "out_cli_pe.mr")),
        (["-1", "reads_150_1.fastq", "-2", "reads_150_2.fastq"],
         ("out_mesh_pe_150.mr",)),
    )
    for reads, ours in runs:
        ref = str(tmp / f"jax_{reads[1]}.mr")
        args = [a if a.startswith("-") else str(work / a) for a in reads]
        out = subprocess.run(
            [sys.executable, "-m", "walt_tpu.cli", "-i", index, *args, "-o",
             ref, "--backend", "numpy"],
            capture_output=True, text=True, timeout=600, cwd=ROOT,
            env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert out.returncode == 0, out.stderr[-2000:]
        for name in ours:
            for suffix in ("", ".mapstats"):
                assert (work / (name + suffix)).read_bytes() == open(
                    ref + suffix, "rb").read(), name + suffix


# ---- pre-flight ------------------------------------------------------------

G = 2**30
HG19 = 3_100_000_000


def _load_tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "hg19_scale_torch", os.path.join(ROOT, "tools", "hg19_scale_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: a four-card H100 machine: 45 GiB of disk writes, a 192 GiB RAM spill
#: directory, 380 GiB of host memory
FOUR_CARDS = dict(n_reads=50_000, spill=True, disk_limit=45 * G,
                  work_free=400 * G, spill_free=192 * G,
                  mem_available=380 * G, n_cards=4, card_bytes=int(79.1 * G))
SE_CARDS = "the 2-table plan needs tp=4 and"
PE_CARDS = "the 4-table plan needs tp=4 and"


@pytest.mark.parametrize("change,refusal", [
    ({}, None),
    # one card that holds every shard of both plans: a virtual mesh is
    # allowed
    (dict(n_cards=1, card_bytes=160 * G), None),
    (dict(spill=False), "to disk, past the 45.00 GiB limit"),
    (dict(work_free=20 * G), "the work directory needs"),
    (dict(spill_free=8 * G), "the spill directory needs"),
    (dict(mem_available=64 * G), "host memory: the run needs"),
    (dict(n_cards=1, card_bytes=40 * G), (SE_CARDS + " 1 card",
                                          PE_CARDS + " 1 card")),
    (dict(n_cards=2, card_bytes=48 * G), (SE_CARDS + " 2 card",
                                          PE_CARDS + " 2 card")),
    # PE: an H100 holds every SE shard, not PE's four tables
    (dict(n_cards=1), PE_CARDS + " 1 card"),
    # PE: the spill directory holds GA10 and GA11 to the end, not one
    (dict(spill_free=20 * G), "GiB for 2 tables, 20.00 GiB free"),
    # PE: the builds' peak fits, the four cached tables' does not
    (dict(mem_available=110 * G), "host memory: the run needs 115.61 GiB"),
])
def test_preflight(change, refusal):
    """hg19 SE and PE on an H100's memory plan tp=4; the pre-flight refuses
    each resource that cannot hold the run, with its numbers, once per plan
    a card check refuses."""
    from walt_tpu_torch import hbm_plan

    tool = _load_tool()
    plans = [hbm_plan.plan_tables(HG19, n, int(79.1 * G), uniq_ratio=0.93)
             for n in (2, 4)]
    assert [p.tp for p in plans] == [4, 4]
    needs, problems = tool.preflight(HG19, plans,
                                     **dict(FOUR_CARDS, **change))
    if refusal is None:
        assert problems == []
    else:
        want = (refusal,) if isinstance(refusal, str) else refusal
        assert len(problems) == len(want), problems
        for w, p in zip(want, problems):
            assert w in p and "GiB" in p, problems
    # FASTA + CT00 + CT01 on disk (~32 GiB), GA10 + GA11 (~28.9 GiB) in RAM
    spill = change.get("spill", True)
    assert 31 < needs["disk_gib"] < 33 if spill else needs["disk_gib"] > 60
    assert 28 < needs["spill_gib"] < 30 if spill else needs["spill_gib"] == 0
    # the builds' peak with GA10 spilled; the mapping stages' four cached
    # tables with both spilled
    if spill:
        assert 83 < needs["host_ram_build_gib"] < 84
        assert needs["host_ram_gib"] == needs["host_ram_maps_gib"] > 115


def test_tree_bytes_counts_a_link_as_itself(tmp_path):
    """The disk limit counts bytes written: a table linked into the work
    directory from a RAM spill directory adds its link, not the table."""
    tool = _load_tool()
    work, spill = tmp_path / "work", tmp_path / "spill"
    work.mkdir()
    spill.mkdir()
    (work / "t_CT00").write_bytes(b"x" * 1000)
    (spill / "t_GA10").write_bytes(b"y" * 5000)
    (work / "t_GA10").symlink_to(spill / "t_GA10")
    link = len(str(spill / "t_GA10"))
    assert tool.tree_bytes(str(work)) == 1000 + link
    assert tool.tree_bytes(str(spill)) == 5000


def test_preflight_refusal_exits_before_stage_1(tmp_path):
    """A run past the disk limit stops at pre-flight, non-zero, with the
    numbers, and writes no genome."""
    out = _tool(tmp_path, 8.0, WALTX_HG19_DISK_GIB="0.01")
    assert out.returncode == 2
    assert "past the 0.01 GiB limit" in out.stderr
    assert "refused before stage 1" in out.stderr
    assert not (tmp_path / "work" / "genome.fa").exists()
    assert out.stdout == ""
