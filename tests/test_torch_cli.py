"""The port's CLI, end to end on the CPU.

``python -m walt_tpu_torch.cli --device cpu`` must write MR/SAM output and
``.mapstats`` byte-identical to ``walt_tpu.cli --backend numpy`` (the exact
host oracle) for every flag set below, and to ``--backend jax`` for the
default flags and ``-A``.  A subprocess shows that the port runs without
importing JAX (this test process has it loaded through tests/conftest.py).
"""

import os
import subprocess
import sys

import pytest
import torch

from walt_tpu_torch import cli as tcli

FLAG_SETS = [[], ["-sam"], ["-u"], ["-a"], ["-A"], ["-b", "3"]]


def _outputs(out, flags):
    files = [out, out + ".mapstats"]
    if "-sam" not in flags:
        files += [out + "_unmapped"] if "-u" in flags else []
        files += [out + "_ambiguous"] if "-a" in flags else []
    return files


def _assert_same(a, b, flags):
    for fa, fb in zip(_outputs(a, flags), _outputs(b, flags)):
        with open(fa, "rb") as x, open(fb, "rb") as y:
            assert x.read() == y.read(), os.path.basename(fa)


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


_NO_JAX = r"""
import importlib, pkgutil, sys
import walt_tpu_torch
for m in pkgutil.walk_packages(walt_tpu_torch.__path__, "walt_tpu_torch."):
    importlib.import_module(m.name)
from walt_tpu_torch import cli
assert cli.main(sys.argv[1:]) == 0
assert "jax" not in sys.modules, "walt_tpu_torch imported jax"
print("NO_JAX_OK")
"""


def test_cli_runs_without_jax(tmp_path, my_index, se_fastq):
    env = {k: v for k, v in os.environ.items() if k != "WALTX_PROFILE_DIR"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root
    out = str(tmp_path / "sub.mr")
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, "-i", my_index, "-r", se_fastq,
         "-o", out, "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout
    assert os.path.getsize(out) > 0


@pytest.mark.parametrize("extra,match", [
    (["-1", "a.fq", "-2", "b.fq"], "paired-end"),
    (["--tp", "2"], "--tp"),
    (["--multihost"], "--multihost"),
    (["--device", "cuda"], "no CUDA device"),
    (["WALTX_PROFILE_DIR"], "WALTX_PROFILE_DIR"),
])
def test_cli_rejects_unported(tmp_path, monkeypatch, my_index, se_fastq,
                              extra, match):
    if "cuda" in extra and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    if extra == ["WALTX_PROFILE_DIR"]:
        monkeypatch.setenv("WALTX_PROFILE_DIR", str(tmp_path / "prof"))
        extra = []
    args = ["-i", my_index, "-o", str(tmp_path / "o.mr"), *extra]
    if "-1" not in extra:
        args += ["-r", se_fastq]
    with pytest.raises(SystemExit, match=match):
        tcli.main(args)
