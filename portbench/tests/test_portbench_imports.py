"""What a run may import: nothing whose top-level name, compared whole, is
``jax``, ``jaxlib``, ``flax`` or ``walt_tpu`` (the port's own name begins
with it); and the reference and the generators nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
FORBIDDEN = {"jax", "jaxlib", "flax", "walt_tpu"}


def top_level_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def run_files():
    return (glob.glob(os.path.join(PKG, "*.py"))
            + glob.glob(os.path.join(PKG, "metrics", "*.py")))


def test_no_forbidden_import_in_what_a_run_loads():
    for path in run_files():
        bad = top_level_imports(path) & FORBIDDEN
        assert not bad, (path, bad)


def test_names_compared_whole():
    """``walt_tpu_torch`` passes, ``walt_tpu`` and ``jax.numpy`` do not."""
    from portbench import harness

    assert "walt_tpu_torch".split(".")[0] not in harness.FORBIDDEN
    for name in ("walt_tpu.cli", "jax.numpy", "flax"):
        assert name.split(".")[0] in harness.FORBIDDEN


def test_reference_and_generators_stand_apart():
    for name in ("reference.py", "gen.py", "roofline.py"):
        mods = top_level_imports(os.path.join(PKG, name))
        assert not mods & (FORBIDDEN | {"walt_tpu_torch"}), (name, mods)
        assert mods <= {"__future__", "dataclasses", "numpy", "torch"}, mods


def test_harness_modules_load_no_forbidden_module():
    """In a fresh process: the harness, the reference, every metric reader
    and the program's drivers leave no forbidden module loaded."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import harness, outcheck, devtrace, control\n"
        "import json, glob, os\n"
        "for p in glob.glob(os.path.join(%r, 'metrics', '*.py')):\n"
        "    harness.metric_reader(%r, os.path.basename(p)[:-3])\n"
        "from walt_tpu_torch.core import single_end, paired_end, backends\n"
        "from walt_tpu_torch.core import torch_backend\n"
        "print(harness.forbidden_modules())\n" % (REPO, PKG, REPO))
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert got.returncode == 0, got.stderr[-2000:]
    assert got.stdout.strip().splitlines()[-1] == "[]"
