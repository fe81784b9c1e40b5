"""tools/hg19_scale_torch.py at a toy size on the CPU: every stage runs,
the planned tp=2 and tp=4 meshes' outputs (100 and 150 bp reads) and the
CLI's are byte-identical to the exact host path and to walt_tpu's CLI, the
spilled tables are checked and removed, the pre-flight refuses a run that
cannot finish, and no report is written off the card."""

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
    # tables on one card, and half of them with the uniq index: the plan
    # splits them tp=2, uniq (memory decides here; the entry limit decides
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
    assert rep["mesh_map"]["accel"] == "uniq"
    assert rep["plan"].startswith("0.00 Gbp x 2 tables: tp=2, uniq")
    # the heavier of the two bucket-range shards of a uniform genome's
    # C->T tables holds ~3/4 of their entries (G and T)
    assert 0.7 < rep["heaviest_shard_entries"] / 1_000_000 < 0.8
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


@pytest.fixture(scope="module")
def run_tp4(tmp_path_factory):
    """The tool at a toy size with a budget between the model's tp=4 uniq
    card and its tp=2 key16 card (the plan's cheapest layouts on either
    side), so it plans tp=4 with the uniq rung; GA10 and GA11 spilled."""
    from walt_tpu_torch import hbm_plan

    tmp = tmp_path_factory.mktemp("hg19_tp4")
    lo = hbm_plan.card_bytes(TOY_BP, 2, 4, True, 0.93)
    hi = hbm_plan.card_bytes(TOY_BP, 2, 2, False, 0.93)
    assert lo < hi
    out = _tool(tmp, (TorchBackend.HBM_RESERVE + (lo + hi) / 2) / 2**30,
                "--spill-dir", str(tmp / "spill"))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout), tmp


def test_hg19_tool_tp4_spill_two_lengths(run_tp4):
    rep, tmp = run_tp4
    work, spill = tmp / "work", tmp / "spill"
    assert rep["plan"].startswith("0.00 Gbp x 2 tables: tp=4, uniq")
    mm = rep["mesh_map"]
    assert (mm["tp"], mm["accel"], mm["virtual"]) == (4, "uniq", True)
    assert set(mm["by_length"]) == {"100", "150"}
    assert all(v["fallback_pct"] < 100 for v in mm["by_length"].values())
    # the spilled tables were checked and are gone from both directories
    assert rep["spill"]["tables"] == ["GA10", "GA11"]
    assert rep["spill"]["peak_gib"] > 0
    assert not list(spill.iterdir())
    assert sorted(p.name for p in work.glob("hg19s.dbindex_*")) == [
        "hg19s.dbindex_CT00", "hg19s.dbindex_CT01"]
    assert all(t["sha_ok"] for t in rep["round_trip"].values())
    assert len(rep["round_trip"]) == 4
    assert {c: t["dir"] for c, t in rep["tables"].items()} == {
        "CT00": "work", "CT01": "work", "GA10": "spill", "GA11": "spill"}
    # every byte the tool wrote under the work directory
    assert rep["disk_written_bytes"] == sum(
        p.stat().st_size for p in work.rglob("*") if p.is_file())
    assert rep["disk_written_gib"] == round(rep["disk_written_bytes"] / 2**30,
                                            2)
    # host, mesh (both lengths) and CLI bytes are equal
    assert set(rep["parities"]) == {"mesh_100", "mesh_150", "cli_100"}
    assert all(all(p.values()) for p in rep["parities"].values())
    assert rep["cli_map"]["rc"] == 0
    assert rep["cli_map"]["stand_ins"] == ["hg19s.dbindex_GA10",
                                           "hg19s.dbindex_GA11"]
    assert rep["host_map"]["100"]["unique"] > 0.9 * 500
    assert rep["host_map"]["150"]["unique"] > 0.9 * 500
    assert not (tmp / "report.json").exists()


def test_hg19_port_equals_walt_tpu_cli(run_tp4):
    """The port's mesh and CLI outputs equal walt_tpu's CLI on its numpy
    backend (the host oracle) on the same index and reads.  walt_tpu's CLI
    checks all four table files like the port's; SE reads CT00 and CT01,
    so the spilled two stand in as empty files here."""
    _, tmp = run_tp4
    work = tmp / "work"
    index = str(work / "hg19s.dbindex")
    stand_ins = [work / f"hg19s.dbindex_{c}" for c in ("GA10", "GA11")]
    try:
        for p in stand_ins:
            p.touch()
        for fq, ours in (("reads.fastq", ("out_mesh.mr", "out_cli.mr")),
                         ("reads_150.fastq", ("out_mesh_150.mr",))):
            ref = str(tmp / f"jax_{fq}.mr")
            out = subprocess.run(
                [sys.executable, "-m", "walt_tpu.cli", "-i", index, "-r",
                 str(work / fq), "-o", ref, "--backend", "numpy"],
                capture_output=True, text=True, timeout=600, cwd=ROOT,
                env=dict(os.environ, JAX_PLATFORMS="cpu"))
            assert out.returncode == 0, out.stderr[-2000:]
            for name in ours:
                for suffix in ("", ".mapstats"):
                    assert (work / (name + suffix)).read_bytes() == open(
                        ref + suffix, "rb").read(), name + suffix
    finally:
        for p in stand_ins:
            p.unlink()


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


@pytest.mark.parametrize("change,refusal", [
    ({}, None),
    # one card that holds every shard: a virtual mesh is allowed
    (dict(n_cards=1), None),
    (dict(spill=False), "to disk, past the 45.00 GiB limit"),
    (dict(work_free=20 * G), "the work directory needs"),
    (dict(spill_free=8 * G), "the spill directory needs"),
    (dict(mem_available=64 * G), "host memory: the run needs"),
    (dict(n_cards=1, card_bytes=40 * G), "the plan needs tp=4 and 1 card"),
    (dict(n_cards=2, card_bytes=48 * G), "the plan needs tp=4 and 2 card"),
])
def test_preflight(change, refusal):
    """hg19 SE on an H100's memory plans tp=4; the pre-flight refuses each
    resource that cannot hold the run, with its numbers."""
    from walt_tpu_torch import hbm_plan

    tool = _load_tool()
    plan = hbm_plan.plan_tables(HG19, 2, int(79.1 * G), uniq_ratio=0.93)
    assert plan.tp == 4
    needs, problems = tool.preflight(HG19, plan, **dict(FOUR_CARDS, **change))
    if refusal is None:
        assert problems == []
    else:
        assert len(problems) == 1 and refusal in problems[0], problems
        assert "GiB" in problems[0]
    # FASTA + CT00 + CT01 on disk (~32 GiB), one table (~14.5 GiB) in RAM
    spill = change.get("spill", True)
    assert 31 < needs["disk_gib"] < 33 if spill else needs["disk_gib"] > 60
    assert 14 < needs["spill_gib"] < 15 if spill else needs["spill_gib"] == 0


def test_preflight_refusal_exits_before_stage_1(tmp_path):
    """A run past the disk limit stops at pre-flight, non-zero, with the
    numbers, and writes no genome."""
    out = _tool(tmp_path, 8.0, WALTX_HG19_DISK_GIB="0.01")
    assert out.returncode == 2
    assert "past the 0.01 GiB limit" in out.stderr
    assert "refused before stage 1" in out.stderr
    assert not (tmp_path / "work" / "genome.fa").exists()
    assert out.stdout == ""
