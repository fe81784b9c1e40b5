"""The harness end to end on the CPU at a tiny size: each cell's run is
correct, a run with the timed path broken is not, the control fails the
check, files added under the benchmark's directories are found by name,
a run without a card exits non-zero, and a run writes only where it may."""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from portbench import harness
from portbench.control import control_readings

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)


def tiny_run(root, cell, seed=12345678901, seconds=1.0, trace=False,
             faults=None):
    return harness.run_cell(root, cell, seed, seconds, trace, "cpu",
                            time.perf_counter(), faults=faults)


@pytest.mark.parametrize("cell", ["t.se100", "t.pe2x100", "t.se_trim",
                                  "t.pe2x50"])
def test_tiny_cell_is_correct(tiny_root, cell):
    result, info = tiny_run(tiny_root, cell, trace=cell == "t.se_trim")
    assert result["correct"], result["checked"]
    assert list(result)[-1] == "checked"
    assert result["attempted"] == info["fed"] > 0
    assert result["failed"] == 0
    assert "setup_s" in result["metrics"] or "breakdown" in result
    if cell == "t.se_trim":
        # the SE device share, from the backend's own counters
        assert 0 < result["metrics"]["backend.device_share.se"]["value"] < 100


def _halve_se(backend):
    """Half of each batch left out: its reads come back resolved and
    unmapped, so the driver writes nothing for them."""
    real = backend.map_single_end

    def call(codes, lens, *a, **k):
        pos, times, minus, mm, fb = real(codes, lens, *a, **k)
        h = len(lens) // 2
        times[h:], fb[h:] = 0, False
        return pos, times, minus, mm, fb

    backend.map_single_end = call


def _shift_se(backend):
    """An answer altered where it is produced: every resolved position
    moves by one base."""
    real = backend.map_single_end

    def call(*a, **k):
        pos, times, minus, mm, fb = real(*a, **k)
        return pos + (~fb).astype(pos.dtype), times, minus, mm, fb

    backend.map_single_end = call


def _halve_pe(backend):
    real = backend.map_mate_slabs_finish

    def call(handle):
        streams, fb = real(handle)
        h = fb.shape[0] // 2
        for st in streams:
            st["cnt"][h:] = 0
        fb[h:] = False
        return streams, fb

    backend.map_mate_slabs_finish = call


def _shift_pe(backend):
    real = backend.map_mate_slabs_finish

    def call(handle):
        streams, fb = real(handle)
        for st in streams:
            st["pos"] += 1
        return streams, fb

    backend.map_mate_slabs_finish = call


@pytest.mark.parametrize("cell,fault", [
    ("t.se100", _halve_se), ("t.se100", _shift_se),
    ("t.se_trim", _halve_se), ("t.pe2x100", _halve_pe),
    ("t.pe2x100", _shift_pe), ("t.pe2x50", _halve_pe)])
def test_broken_timed_path_is_not_correct(tiny_root, cell, fault):
    result, _ = tiny_run(tiny_root, cell, faults=fault)
    assert not result["correct"]
    wrong = {c["name"]: c["value"] for c in result["checked"]}
    assert wrong["records_wrong"] > 0


@pytest.mark.parametrize("cell", ["t.se100", "t.pe2x100", "t.se_trim",
                                  "t.pe2x50"])
def test_control_fails_the_check(tiny_root, cell):
    """The reference with one seed shift in the program's place (see
    control.py), its output judged by the harness's own check, comes out
    not correct, on records_wrong alone; the reference with every shift in
    the program's place comes out correct."""
    got = control_readings(tiny_root, cell, 31, 1, "cpu")
    assert not got["correct"]
    assert got["checked"]["records_wrong"][0] > 0
    assert all(v == 0 for k, (v, _) in got["checked"].items()
               if k != "records_wrong")
    same = control_readings(tiny_root, cell, 31, 99, "cpu")
    assert same["correct"], same["checked"]


def test_added_files_are_found_by_name(tiny_root, tmp_path):
    """A new configuration, traffic mix and metric are files and entries,
    with no edit to an existing file."""
    root = str(tmp_path / "root")
    shutil.copytree(tiny_root, root, ignore=shutil.ignore_patterns("cache"))
    before = {p: _read(p) for p in _files(root)}
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    with open(os.path.join(root, "portbench/configs/tiny_p3.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny_p5", seed_pattern="5")
    with open(os.path.join(root, "portbench/configs/tiny_p5.json"), "w") as f:
        json.dump(cfg, f)
    traffic = dict(mode="se", read_len=75, batch=1000, pool=3000, sample=50,
                   warm_batches=1)
    with open(os.path.join(root, "portbench/traffic/se75.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(root, "portbench/metrics/fed_reads.py"),
              "w") as f:
        f.write("def read(run):\n    return float(run['n'])\n")
    spec["configs"].append(dict(name="tiny_p5", source="tiny",
                                file="portbench/configs/tiny_p5.json",
                                reduced=[], why="added"))
    spec["workloads"].append(dict(name="t5.se75", config="tiny_p5",
                                  traffic="se75", chips=1, why="added"))
    spec["per_layer"].append(dict(name="fed_reads", unit="reads",
                                  better="higher", source="host_clock",
                                  layer="driver", moves="reads_per_s",
                                  workloads=["t5.se75"]))
    for m in spec["end_to_end"]:
        if m["name"] == "reads_per_s":
            m["workloads"].append("t5.se75")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    for p, data in before.items():
        if not p.endswith("BENCHMARK.json"):
            assert _read(p) == data, p
    result, _ = tiny_run(root, "t5.se75", trace=True)
    assert result["correct"], result["checked"]
    assert result["metrics"]["fed_reads"]["value"] == result["attempted"]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _files(root):
    return [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs]


def test_run_without_a_card_exits_non_zero(tmp_path):
    """No card: no result, a non-zero exit.  (Here the CPU build of torch
    has none; on a machine with a card the test has nothing to show.)"""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    got = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "athal_p3.pe2x100", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=REPO, timeout=300)
    assert got.returncode != 0 and not got.stdout.strip()
    assert "no CUDA device" in got.stderr


def test_run_with_only_the_benchmark_exits_non_zero(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    got = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "athal_p3.pe2x100", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=str(tmp_path), timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert got.returncode != 0 and not got.stdout.strip()


GUARD = r'''
import os, sys, time
allowed = [os.path.realpath(p) for p in sys.argv[2:]]
log = []
def hook(event, args):
    if event == "open" and args[0] is not None and not isinstance(args[0], int):
        mode, flags = args[1], args[2]
        writes = (mode and any(c in mode for c in "wax+")) or (
            flags and flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT))
        if writes:
            log.append(os.path.realpath(os.fsdecode(args[0])))
    elif event in ("os.mkdir", "os.rename", "os.symlink", "os.remove",
                   "shutil.rmtree"):
        log.append(os.path.realpath(os.fsdecode(args[0])))
sys.addaudithook(hook)
sys.path.insert(0, %r)
sys.path.insert(1, sys.argv[1])
from portbench import harness
res, info = harness.run_cell(sys.argv[1], "t.se100", 5, 1.0, False, "cpu",
                             time.perf_counter())
assert res["correct"], res["checked"]
anonymous = ("/proc/", "/memfd:", "/dev/null")
bad = sorted({p for p in log if not p.startswith(anonymous)
              and not any(p == a or p.startswith(a + os.sep)
                          for a in allowed)})
print("OUTSIDE", bad)
'''


def test_run_writes_only_where_it_may(tiny_root, tmp_path):
    """Every file a run opens for writing, and every directory or link it
    makes, lies under the checkout, HOME, XDG_CACHE_HOME or TMPDIR; the
    in-memory output files (memfd, reached through /proc) and /dev/null
    hold nothing on disk."""
    home, xdg, tmp = (tmp_path / n for n in ("home", "xdg", "tmp"))
    for d in (home, xdg, tmp):
        d.mkdir()
    root = str(tmp_path / "root")
    shutil.copytree(tiny_root, root, ignore=shutil.ignore_patterns("cache"))
    env = dict(os.environ, HOME=str(home), XDG_CACHE_HOME=str(xdg),
               TMPDIR=str(tmp))
    got = subprocess.run(
        [sys.executable, "-c", GUARD % REPO, root, root, REPO, str(home),
         str(xdg), str(tmp)], capture_output=True, text=True, env=env,
        timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    assert got.stdout.strip().splitlines()[-1] == "OUTSIDE []"


@pytest.mark.cuda
def test_cell_runs_on_the_card():
    """One short run of the benchmark's cell on the card, with its result
    line."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "athal_p3.pe2x100", "--seed", "7", "--seconds", "5",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=REPO, timeout=1200)
    assert got.returncode == 0, got.stderr[-3000:]
    result = json.loads(got.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert np.isfinite(result["metrics"]["pairs_per_s"]["value"])
