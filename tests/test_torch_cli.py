"""The port's CLI, end to end on the CPU.

``python -m walt_tpu_torch.cli --device cpu`` must write MR/SAM output and
``.mapstats`` byte-identical to ``walt_tpu.cli --backend numpy`` (the exact
host oracle) for every flag set below, single-end (``-r``) and paired-end
(``-1``/``-2``), and to ``--backend jax`` for the default flags and ``-A``
(SE) or ``-sam`` (PE).  ``--tp 2 --device cpu`` (one device: the table
stays whole) is byte-identical to ``--backend numpy``; ``index`` and
``merge-stats`` equal walt_tpu's.  A subprocess shows that the port, its
``parallel`` package included, runs without importing JAX (this test
process has it loaded through tests/conftest.py).
"""

import os
import subprocess
import sys

import pytest
import torch

from walt_tpu_torch import cli as tcli

FLAG_SETS = [[], ["-sam"], ["-u"], ["-a"], ["-A"], ["-b", "3"]]
PE_FLAG_SETS = [[], ["-sam"], ["-a", "-u"], ["-P"], ["-L", "300"],
                ["-k", "10"]]


def _outputs(out, flags, pe=False):
    files = [out, out + ".mapstats"]
    if "-sam" not in flags:
        for m in ("_1", "_2") if pe else ("",):
            files += [f"{out}{m}_unmapped"] if "-u" in flags else []
            files += [f"{out}{m}_ambiguous"] if "-a" in flags else []
    return files


def _assert_same(a, b, flags, pe=False):
    for fa, fb in zip(_outputs(a, flags, pe), _outputs(b, flags, pe)):
        with open(fa, "rb") as x, open(fb, "rb") as y:
            assert x.read() == y.read(), os.path.basename(fa)


def _reads_args(pe_fastq):
    return ["-1", pe_fastq[0], "-2", pe_fastq[1]]


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: " ".join(f) or "default")
def test_cli_matches_numpy_backend(tmp_path, my_index, se_fastq, flags):
    from walt_tpu.cli import main_map

    ref, out = str(tmp_path / "numpy.mr"), str(tmp_path / "torch.mr")
    main_map(["-i", my_index, "-r", se_fastq, "-o", ref, "--backend",
              "numpy", *flags])
    assert tcli.main(["-i", my_index, "-r", se_fastq, "-o", out,
                      "--device", "cpu", *flags]) == 0
    _assert_same(ref, out, flags)


@pytest.mark.parametrize("flags", [[], ["-A"]],
                         ids=lambda f: " ".join(f) or "default")
def test_cli_matches_jax_backend(tmp_path, my_index, se_fastq, flags):
    from walt_tpu.cli import main_map

    ref, out = str(tmp_path / "jax.mr"), str(tmp_path / "torch.mr")
    main_map(["-i", my_index, "-r", se_fastq, "-o", ref, "--backend", "jax",
              *flags])
    tcli.main(["-i", my_index, "-r", se_fastq, "-o", out, "--device", "cpu",
               *flags])
    _assert_same(ref, out, flags)


@pytest.mark.parametrize("flags", PE_FLAG_SETS,
                         ids=lambda f: " ".join(f) or "default")
def test_pe_cli_matches_numpy_backend(tmp_path, my_index, pe_fastq, flags):
    from walt_tpu.cli import main_map

    ref, out = str(tmp_path / "numpy.mr"), str(tmp_path / "torch.mr")
    main_map(["-i", my_index, *_reads_args(pe_fastq), "-o", ref,
              "--backend", "numpy", *flags])
    assert tcli.main(["-i", my_index, *_reads_args(pe_fastq), "-o", out,
                      "--device", "cpu", *flags]) == 0
    _assert_same(ref, out, flags, pe=True)


@pytest.mark.parametrize("flags", [[], ["-sam"]],
                         ids=lambda f: " ".join(f) or "default")
def test_pe_cli_matches_jax_backend(tmp_path, my_index, pe_fastq, flags):
    from walt_tpu.cli import main_map

    ref, out = str(tmp_path / "jax.mr"), str(tmp_path / "torch.mr")
    main_map(["-i", my_index, *_reads_args(pe_fastq), "-o", ref,
              "--backend", "jax", *flags])
    assert tcli.main(["-i", my_index, *_reads_args(pe_fastq), "-o", out,
                      "--device", "cpu", *flags]) == 0
    _assert_same(ref, out, flags, pe=True)


def test_se_and_pe_in_one_run(tmp_path, my_index, se_fastq, pe_fastq):
    """-r and -1/-2 together: the SE file maps first, then the pair, each
    into its own output, as walt_tpu's CLI does."""
    from walt_tpu.cli import main_map

    ref = [str(tmp_path / f"numpy_{k}.mr") for k in ("se", "pe")]
    out = [str(tmp_path / f"torch_{k}.mr") for k in ("se", "pe")]
    main_map(["-i", my_index, "-r", se_fastq, *_reads_args(pe_fastq), "-o",
              ",".join(ref), "--backend", "numpy"])
    assert tcli.main(["-i", my_index, "-r", se_fastq, *_reads_args(pe_fastq),
                      "-o", ",".join(out), "--device", "cpu"]) == 0
    _assert_same(ref[0], out[0], [])
    _assert_same(ref[1], out[1], [], pe=True)


_NO_JAX = r"""
import importlib, pkgutil, sys
import walt_tpu_torch
for m in pkgutil.walk_packages(walt_tpu_torch.__path__, "walt_tpu_torch."):
    importlib.import_module(m.name)
for m in ("walt_tpu_torch.parallel.sharded", "walt_tpu_torch.parallel.multihost",
          "walt_tpu_torch.entry"):
    assert m in sys.modules, m
from walt_tpu_torch import cli
assert cli.main(sys.argv[1:]) == 0
assert "jax" not in sys.modules, "walt_tpu_torch imported jax"
assert not [m for m in sys.modules if m.split(".")[0] == "walt_tpu"]
print("NO_JAX_OK")
"""


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_cli_runs_without_jax(tmp_path, my_index, se_fastq, pe_fastq, mode):
    env = {k: v for k, v in os.environ.items() if k != "WALTX_PROFILE_DIR"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root
    out = str(tmp_path / "sub.mr")
    reads = ["-r", se_fastq] if mode == "se" else _reads_args(pe_fastq)
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, "-i", my_index, *reads,
         "-o", out, "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout
    assert os.path.getsize(out) > 0


@pytest.mark.parametrize("extra,match", [
    (["--device", "cuda"], "no CUDA device"),
    (["WALTX_PROFILE_DIR"], "WALTX_PROFILE_DIR"),
])
def test_cli_rejects_unported(tmp_path, monkeypatch, my_index, se_fastq,
                              extra, match):
    """``--device cuda`` without a card is refused.  ``WALTX_PROFILE_DIR``
    (refused while the port had no profiler hook of its own) now writes a
    torch.profiler Chrome trace of the mapping loop, and the output stays
    byte-identical to ``--backend numpy``."""
    if "cuda" in extra and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = ["-i", my_index, "-o", str(tmp_path / "o.mr"), "-r", se_fastq]
    if extra == ["WALTX_PROFILE_DIR"]:
        import json

        from walt_tpu.cli import main_map

        prof = tmp_path / "prof"
        monkeypatch.setenv(match, str(prof))
        assert tcli.main(args + ["--device", "cpu"]) == 0
        traces = sorted(prof.glob("*.json"))
        assert len(traces) == 1
        with open(traces[0]) as f:
            assert json.load(f)["traceEvents"]
        monkeypatch.delenv(match)
        main_map(["-i", my_index, "-o", str(tmp_path / "ref.mr"), "-r",
                  se_fastq, "--backend", "numpy"])
        _assert_same(str(tmp_path / "ref.mr"), str(tmp_path / "o.mr"), [])
        return
    with pytest.raises(SystemExit, match=match):
        tcli.main(args + extra)


def test_tp_on_one_cpu_device_matches_numpy(tmp_path, my_index, se_fastq,
                                            pe_fastq):
    from walt_tpu.cli import main_map

    ref = [str(tmp_path / f"numpy_{k}.mr") for k in ("se", "pe")]
    out = [str(tmp_path / f"torch_{k}.mr") for k in ("se", "pe")]
    main_map(["-i", my_index, "-r", se_fastq, *_reads_args(pe_fastq), "-o",
              ",".join(ref), "--backend", "numpy"])
    assert tcli.main(["-i", my_index, "-r", se_fastq, *_reads_args(pe_fastq),
                      "-o", ",".join(out), "--device", "cpu", "--tp",
                      "2"]) == 0
    _assert_same(ref[0], out[0], [])
    _assert_same(ref[1], out[1], [], pe=True)


def test_index_matches_walt_tpu(tmp_path, work):
    from walt_tpu.cli import main as jmain

    ref, out = str(tmp_path / "ref.dbindex"), str(tmp_path / "port.dbindex")
    fasta = str(work / "genome.fa")
    assert jmain(["index", "-c", fasta, "-o", ref]) == 0
    assert tcli.main(["index", "-c", fasta, "-o", out]) == 0
    for suf in ("", "_CT00", "_CT01", "_GA10", "_GA11"):
        with open(ref + suf, "rb") as a, open(out + suf, "rb") as b:
            assert a.read() == b.read(), suf


def test_merge_stats_matches_walt_tpu(tmp_path, my_index, se_fastq,
                                      pe_fastq):
    from walt_tpu.cli import main as jmain

    outs = [str(tmp_path / f"{k}.mr") for k in ("a", "b")]
    for out in outs:
        assert tcli.main(["-i", my_index, "-r", se_fastq, "-o", out,
                          "--device", "cpu"]) == 0
    stats = [o + ".mapstats" for o in outs]
    ref, got = str(tmp_path / "ref.mapstats"), str(tmp_path / "got.mapstats")
    assert jmain(["merge-stats", *stats, "-o", ref]) == 0
    assert tcli.main(["merge-stats", *stats, "-o", got]) == 0
    with open(ref) as a, open(got) as b:
        text = b.read()
        assert a.read() == text
    assert "total_reads: " in text
