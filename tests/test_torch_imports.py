"""walt_tpu_torch stands alone: it imports neither JAX nor walt_tpu.

- An AST scan of every module of the port, ``chip_smoke.py``,
  ``tools/hg19_scale_torch.py``, ``tools/uniq_build_time.py`` and
  ``tools/dp_scaling_torch.py`` finds no import of ``jax`` or ``walt_tpu`` (at any depth: inside
  functions too);
- a subprocess imports every module of the port, runs its CLI on the CPU
  end to end (SE, then PE) and finds neither ``jax`` nor any ``walt_tpu``
  module in ``sys.modules``.
"""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "walt_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "tools", "hg19_scale_torch.py"),
           os.path.join(ROOT, "tools", "uniq_build_time.py"),
           os.path.join(ROOT, "tools", "dp_scaling_torch.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "walt_tpu_torch")):
        out += [os.path.join(d, f) for f in sorted(files) if f.endswith(".py")]
    return out


def _imported(path):
    """Top-level package names of every import statement in ``path``."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [(a.name.split(".")[0], node.lineno) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append((node.module.split(".")[0], node.lineno))
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.append((str(node.args[0].value).split(".")[0], node.lineno))
    return names


def test_sources_import_no_jax_or_walt_tpu():
    srcs = _sources()
    assert len(srcs) > 30  # the port's modules were found
    bad = [f"{os.path.relpath(p, ROOT)}:{line} imports {name}"
           for p in srcs for name, line in _imported(p) if name in FORBIDDEN]
    assert not bad, "\n".join(bad)


def test_ast_scan_sees_nested_imports(tmp_path):
    """The scan catches an import inside a function, as the port's lazy
    imports are written."""
    p = tmp_path / "m.py"
    p.write_text("def f():\n    from walt_tpu.native import get_lib\n"
                 "    import jax.numpy\n")
    assert [n for n, _ in _imported(str(p))] == ["walt_tpu", "jax"]


_RUN = r"""
import importlib, pkgutil, sys
import walt_tpu_torch
for m in pkgutil.walk_packages(walt_tpu_torch.__path__, "walt_tpu_torch."):
    importlib.import_module(m.name)
from walt_tpu_torch import cli
assert cli.main(sys.argv[1:]) == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "walt_tpu"))
assert not bad, bad
print("STANDS_ALONE")
"""


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_cli_subprocess_loads_no_jax_or_walt_tpu(tmp_path, my_index,
                                                 se_fastq, pe_fastq, mode):
    env = {k: v for k, v in os.environ.items() if k != "WALTX_PROFILE_DIR"}
    env["PYTHONPATH"] = ROOT
    out = str(tmp_path / "sub.mr")
    reads = (["-r", se_fastq] if mode == "se"
             else ["-1", pe_fastq[0], "-2", pe_fastq[1]])
    proc = subprocess.run(
        [sys.executable, "-c", _RUN, "-i", my_index, *reads, "-o", out,
         "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "STANDS_ALONE" in proc.stdout
    assert os.path.getsize(out) > 0
