"""tools/hg19_scale_torch.py at a toy size on the CPU: every stage runs,
the planned tp=2 mesh's output is byte-identical to the exact host path,
and no report is written off the card."""

import json
import os
import subprocess
import sys

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
