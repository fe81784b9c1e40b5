"""walt_tpu_torch's multi-process runs (``parallel/multihost``).

- ``shard_round_robin`` and ``merge_mapstats`` equal walt_tpu's, and a
  merge of split runs equals one run over the whole input (SE and PE);
- ``initialize`` without a coordinator is one process;
- two real processes joined over ``torch.distributed`` (gloo, localhost)
  deal SE files and a PE pair round-robin with ``--multihost``: every
  output is byte-identical to a single-host run, the merged ``.mapstats``
  equal one run over both SE files, and neither process imports JAX.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from walt_tpu.parallel import multihost as jmh
from walt_tpu_torch import cli as tcli
from walt_tpu_torch.parallel import multihost as tmh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n", [1, 3, 4])
def test_shard_round_robin_matches_jax(n):
    files = [f"f{i}" for i in range(7)]
    shards = [tmh.shard_round_robin(files, p, n) for p in range(n)]
    assert shards == [jmh.shard_round_robin(files, p, n) for p in range(n)]
    assert sorted(sum(shards, [])) == sorted(files)


def test_initialize_alone(monkeypatch):
    monkeypatch.delenv("WALTX_COORDINATOR", raising=False)
    assert tmh.initialize() == (0, 1)
    tmh.barrier()  # no-op alone


def _clean_fastq(work, path, n, seed, length=80):
    """N-free reads: srand(0) is per batch (mapping.cpp:73), so with Ns two
    splits of one file would legitimately randomize differently."""
    from conftest import simulate_reads, write_fastq
    from walt_tpu_torch.genome import load_genome

    g = load_genome([str(work / "genome.fa")])
    write_fastq(path, simulate_reads(g, np.random.default_rng(seed), n,
                                     length, n_rate=0.0))
    return str(path)


def _clean_pairs(work, tmp_path, n, seed):
    from conftest import simulate_pairs, write_fastq
    from walt_tpu_torch.genome import load_genome

    g = load_genome([str(work / "genome.fa")])
    r1, r2 = simulate_pairs(g, np.random.default_rng(seed), n, 75,
                            n_rate=0.0)
    paths = (str(tmp_path / f"pe{seed}_1.fastq"),
             str(tmp_path / f"pe{seed}_2.fastq"))
    write_fastq(paths[0], r1)
    write_fastq(paths[1], r2)
    return paths


def _halves(path, tmp_path, name):
    recs = open(path).read().rstrip("\n").split("\n")
    cut = (len(recs) // 8) * 4  # a record boundary
    a, b = tmp_path / f"{name}a.fastq", tmp_path / f"{name}b.fastq"
    a.write_text("\n".join(recs[:cut]) + "\n")
    b.write_text("\n".join(recs[cut:]) + "\n")
    return str(a), str(b)


def _map(index, reads, out):
    assert tcli.main(["-i", index, *reads, "-o", out, "--device", "cpu"]) == 0


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_merge_mapstats_matches_jax(tmp_path, work, my_index, mode):
    if mode == "se":
        whole = [_clean_fastq(work, tmp_path / "all.fastq", 64, 3)]
    else:
        whole = list(_clean_pairs(work, tmp_path, 64, 9))
    parts = list(zip(*(_halves(p, tmp_path, f"m{i}")
                       for i, p in enumerate(whole))))
    flag = (["-r"] if mode == "se" else ["-1", "-2"])

    def args(files):
        return [x for f, fl in zip(files, flag) for x in (fl, f)]

    _map(my_index, args(whole), str(tmp_path / "all.mr"))
    stats = []
    for i, files in enumerate(parts):
        out = str(tmp_path / f"part{i}.mr")
        _map(my_index, args(files), out)
        stats.append(out + ".mapstats")
    got, want = str(tmp_path / "t.mapstats"), str(tmp_path / "j.mapstats")
    tmh.merge_mapstats(stats, got)
    jmh.merge_mapstats(stats, want)
    text = open(got).read()
    assert text == open(want).read()
    assert text == open(str(tmp_path / "all.mr.mapstats")).read()


def test_multihost_requires_one_output_per_input(tmp_path, my_index,
                                                  se_fastq):
    with pytest.raises(SystemExit, match="one output file per input"):
        tcli.main(["-i", my_index, "-r", f"{se_fastq},{se_fastq}",
                   "-o", str(tmp_path / "one.mr"), "--device", "cpu",
                   "--multihost"])


_WORKER = r"""
import sys
from walt_tpu_torch import cli
assert cli.main(sys.argv[1:]) == 0
assert "jax" not in sys.modules, "walt_tpu_torch imported jax"
print("WORKER_OK")
"""


def test_multihost_two_processes(tmp_path, work, my_index):
    """Two processes over gloo: SE files f1, f2 and one PE pair dealt
    round-robin (rank 0: f1 and the pair; rank 1: f2)."""
    f1 = _clean_fastq(work, tmp_path / "f1.fastq", 48, 21)
    f2 = _clean_fastq(work, tmp_path / "f2.fastq", 32, 22)
    p1, p2 = _clean_pairs(work, tmp_path, 40, 23)
    outs = [str(tmp_path / f"mh{i}.mr") for i in range(3)]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = ["-i", my_index, "-r", f"{f1},{f2}", "-1", p1, "-2", p2,
            "-o", ",".join(outs), "--device", "cpu", "--multihost"]
    env = {k: v for k, v in os.environ.items() if k != "WALTX_PROFILE_DIR"}
    env.update(PYTHONPATH=ROOT, WALTX_COORDINATOR=f"127.0.0.1:{port}",
               WALTX_NUM_HOSTS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, *argv], cwd=str(tmp_path),
        env=dict(env, WALTX_HOST_ID=str(pid)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        assert "WORKER_OK" in out

    singles = [str(tmp_path / f"sh{i}.mr") for i in range(3)]
    for reads, out in ((["-r", f1], singles[0]), (["-r", f2], singles[1]),
                       (["-1", p1, "-2", p2], singles[2])):
        _map(my_index, reads, out)
    for mh, sh in zip(outs, singles):
        for suf in ("", ".mapstats"):
            assert open(mh + suf, "rb").read() == open(sh + suf, "rb").read()

    merged = str(tmp_path / "merged.mapstats")
    assert tcli.main(["merge-stats", outs[0] + ".mapstats",
                      outs[1] + ".mapstats", "-o", merged]) == 0
    both = tmp_path / "both.fastq"
    both.write_text(open(f1).read() + open(f2).read())
    _map(my_index, ["-r", str(both)], str(tmp_path / "both.mr"))
    assert open(merged).read() == open(str(tmp_path /
                                           "both.mr.mapstats")).read()
