"""walt_tpu_torch.perf: span records, counters and profiler ranges, and the
spans and counters the drivers, the backend and the step cache leave.

A span books its seconds through ``perf.add`` (which the benchmark's
traced run patches) and keeps one record (name, batch, thread, start_ns,
end_ns, cpu_ns, parent) on ``time.time_ns``, the profiler's clock; while a
``torch.profiler`` runs it is also the range ``waltx.<name>``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from walt_tpu_torch import perf
from walt_tpu_torch.core.torch_backend import TorchBackend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: children each driver span must hold in a full batch, by parent
PE_CHILDREN = {
    "host_parse": {"host_parse.fill", "host_parse.native"},
    "device_map": {"backend.pack", "backend.launch", "backend.sync",
                   "backend.decode"},
    "host_emit": {"host_emit.prep", "host_emit.native"},
}


@pytest.fixture
def fresh_perf():
    perf.reset()
    yield perf
    perf.reset()


def _busy(seconds: float) -> None:
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        pass


def test_span_matches_its_profiler_range(fresh_perf):
    from torch.profiler import ProfilerActivity, profile

    with perf.stage("before"):
        _busy(0.002)
    assert not perf._profiling()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        assert perf._profiling()
        for _ in range(3):
            with perf.stage("probe", batch=7):
                with perf.stage("probe.inner"):
                    _busy(0.003)
    finally:
        prof.stop()
    with perf.stage("after"):
        _busy(0.002)
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("waltx."):
            ranges.setdefault(e.name()[6:], []).append(
                (e.start_ns(), e.end_ns()))
    assert set(ranges) == {"probe", "probe.inner"}
    recs = {}
    for r in perf.spans():
        recs.setdefault(r[0], []).append(r)
    assert [len(recs[k]) for k in ("before", "probe", "probe.inner",
                                   "after")] == [1, 3, 3, 1]
    for name in ("probe", "probe.inner"):
        got = sorted(ranges[name])
        want = sorted((r[3], r[4]) for r in recs[name])
        assert len(got) == len(want) == 3
        for (a, z), (s0, s1) in zip(got, want):
            assert abs(a - s0) < 1_000_000 and abs(z - s1) < 1_000_000
    assert all(r[1] == 7 for r in recs["probe"] + recs["probe.inner"])
    assert all(r[6] == "probe" for r in recs["probe.inner"])


def test_no_profiler_no_range_and_no_torch(fresh_perf, monkeypatch):
    """Off, a span opens no profiler range, and the recorder alone does not
    load torch."""

    import torch._C._profiler

    def boom(name):
        raise AssertionError(f"a profiler range {name!r} with no profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)
    with perf.stage("quiet"):
        pass
    assert [r[0] for r in perf.spans()] == ["quiet"]
    code = ("import importlib.util, sys\n"
            "spec = importlib.util.spec_from_file_location('p', sys.argv[1])\n"
            "p = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(p)\n"
            "with p.stage('a'):\n"
            "    p.count('c', 2)\n"
            "assert p.spans()[0][0] == 'a' and p.counters() == {'c': 2}\n"
            "assert 'torch' not in sys.modules, 'torch loaded'\n")
    got = subprocess.run([sys.executable, "-c", code,
                          os.path.join(REPO, "walt_tpu_torch", "perf.py")],
                         capture_output=True, text=True, timeout=120)
    assert got.returncode == 0, got.stderr


def test_record_fields_and_thread_clock(fresh_perf):
    with perf.stage("outer", batch=3):
        c = time.thread_time_ns()
        while time.thread_time_ns() - c < 20_000_000:
            pass
        with perf.stage("inner"):
            time.sleep(0.02)
    inner, outer = perf.spans()
    assert inner[:3] == ("inner", 3, threading.get_ident())
    assert inner[6] == "outer" and outer[6] is None and outer[1] == 3
    assert outer[3] <= inner[3] <= inner[4] <= outer[4]
    # the busy loop runs on the thread's clock, the sleep does not
    assert outer[5] >= 20_000_000
    assert inner[5] < (inner[4] - inner[3]) / 2


def test_reset_and_bound(fresh_perf, monkeypatch):
    monkeypatch.setattr(perf, "MAX_SPANS", 3)
    for i in range(5):
        with perf.stage("s", batch=i):
            pass
    perf.count("x")
    perf.count("x", 4)
    assert [r[1] for r in perf.spans()] == [0, 1, 2]
    assert perf.counters() == {"x": 5, "perf.dropped_spans": 2}
    assert perf._counts["s"] == 5
    perf.reset()
    assert perf.spans() == [] and perf.counters() == {}
    assert perf.snapshot() == {}


def test_patched_add_sees_every_span(fresh_perf, monkeypatch):
    seen = []
    real = perf.add

    def add(stage, seconds, n=1):
        seen.append(stage)
        real(stage, seconds, n)

    monkeypatch.setattr(perf, "add", add)
    with perf.stage("a"):
        with perf.stage("a.b"):
            pass
    with perf.stage("c", batch=1):
        pass
    assert seen == ["a.b", "a", "c"] == [r[0] for r in perf.spans()]
    assert set(perf._stages) == {"a", "a.b", "c"}


def test_counters_are_thread_safe(fresh_perf):
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                perf.count("n")
                with perf.stage("t"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert perf.counters()["n"] == 32000
    assert len(perf.spans()) == 32000
    assert all(r[6] is None for r in perf.spans())


def _contained(recs):
    """Every record with a parent lies inside a record of that parent on
    its thread and batch."""
    for r in recs:
        if r[6] is None:
            continue
        assert any(p[0] == r[6] and p[1] == r[1] and p[2] == r[2]
                   and p[3] <= r[3] and r[4] <= p[4] for p in recs), r


def _by_batch(recs):
    out = {}
    for r in recs:
        out.setdefault(r[1], []).append(r)
    return out


def _watch(backend, name):
    """Wrap ``backend.name`` and collect the fallback mask it returns."""
    got = []
    real = getattr(backend, name)

    def call(*a, **k):
        r = real(*a, **k)
        got.append(r[-1])
        return r

    setattr(backend, name, call)
    return got


def _run_pe(tmp_path, my_index, pe_fastq, backend, batch):
    from walt_tpu_torch.core.paired_end import process_paired_end

    out = str(tmp_path / "pe.mr")
    open(out, "w").close()
    open(out + ".mapstats", "w").close()
    process_paired_end(my_index, pe_fastq[0], pe_fastq[1], out,
                       batch_size=batch, backend=backend)
    return out


def _pairs(path):
    with open(path) as f:
        return sum(1 for _ in f) // 4


def test_paired_end_spans_per_batch(fresh_perf, tmp_path, my_index,
                                    pe_fastq):
    backend = TorchBackend(device="cpu", chunk=64, small_chunk=32)
    fbs = _watch(backend, "map_mate_slabs_finish")
    perf.reset()
    _run_pe(tmp_path, my_index, pe_fastq, backend, 32)
    n = _pairs(pe_fastq[0])
    full = n // 32
    # set-up's table reads (no batch) and placements (the first batch's
    # mapper) are held by test_torch_mesh_trace.py
    recs = [r for r in perf.spans() if not r[0].startswith("setup.")]
    assert len(recs) < len(perf.spans())
    batches = _by_batch(recs)
    assert None not in batches
    assert sorted(batches) == list(range(full + 1))
    main = {r[2] for r in recs if r[0] == "host_parse"}
    assert len(main) == 1
    for i in range(full):
        got = batches[i]
        names = {r[0] for r in got}
        assert {"host_parse", "device_map", "map_wait", "native_finalize",
                "host_emit"} <= names, (i, names)
        for parent, kids in PE_CHILDREN.items():
            assert {r[0] for r in got if r[6] == parent} == kids, (i, parent)
        dm = [r for r in got if r[0] == "device_map"]
        assert len(dm) == 1 and dm[0][2] not in main  # the mapper thread
        for r in got:
            on_mapper = r[0] == "device_map" or r[0].startswith("backend.")
            assert (r[2] in main) != on_mapper, r
        # each mate's parse reads its stream and trims its buffer
        assert sum(r[0] == "host_parse.fill" for r in got) == 4
    _contained(recs)
    # the counters beside pe_finalize
    assert len(fbs) % 2 == 0
    host = sum(int((a | b).sum()) for a, b in zip(fbs[0::2], fbs[1::2]))
    c = perf.counters()
    assert c["driver.pairs"] == n
    assert c["driver.pairs_host"] == host
    assert c["backend.reads"] == 2 * n
    assert c["backend.fallback_reads"] == sum(int(f.sum()) for f in fbs)
    # one (32, 5) uint32 + (32,) int32 chunk per mate and batch
    assert c["backend.h2d_bytes"] == 2 * (full + 1) * 32 * (5 * 4 + 4)
    # the old names' totals are still booked under those names, one
    # booking per record
    for name in ("host_parse", "device_map", "native_finalize",
                 "host_emit"):
        assert perf._counts[name] == sum(r[0] == name for r in recs)
        assert perf._stages[name] > 0


def test_host_fallback_is_a_span(fresh_perf, tmp_path, my_index, pe_fastq):
    """Pairs the device flags (tiny slabs) go through the exact host path,
    under a ``host_fallback`` span of their batch."""
    backend = TorchBackend(device="cpu", chunk=64, small_chunk=32,
                           cand_slab=2)
    perf.reset()
    _run_pe(tmp_path, my_index, pe_fastq, backend, 64)
    fb = [r for r in perf.spans() if r[0] == "host_fallback"]
    assert fb and perf.counters()["driver.pairs_host"] > 0
    assert {r[1] for r in fb} <= {0, 1, 2}
    assert perf._counts["host_fallback"] == len(fb)
    assert perf._stages["host_fallback"] > 0


def test_single_end_spans_and_counters(fresh_perf, tmp_path, my_index,
                                       se_fastq):
    from walt_tpu_torch.core.single_end import process_single_end

    backend = TorchBackend(device="cpu", chunk=64, small_chunk=32)
    fbs = _watch(backend, "map_single_end")
    out = str(tmp_path / "se.mr")
    open(out, "w").close()
    open(out + ".mapstats", "w").close()
    perf.reset()
    process_single_end(my_index, se_fastq, out, batch_size=40,
                       backend=backend)
    n = _pairs(se_fastq)
    recs = perf.spans()
    batches = _by_batch(recs)
    for i in range(n // 40):
        names = {r[0] for r in batches[i]}
        assert {"host_parse", "host_parse.fill", "host_parse.native",
                "device_map", "backend.pack", "backend.launch",
                "backend.sync", "backend.decode", "map_wait",
                "host_fallback", "host_emit", "host_emit.prep",
                "host_emit.native"} <= names, (i, names)
    _contained(recs)
    c = perf.counters()
    assert c["driver.reads"] == n
    assert c["driver.reads_host"] == sum(int(f.sum()) for f in fbs)


def test_step_cache_counts_new_entries(fresh_perf, tmp_path, my_index,
                                       pe_fastq):
    """``graphs.captures``: one per new step key, none once every chunk
    shape was seen."""
    backend = TorchBackend(device="cpu", chunk=64, small_chunk=32)
    _run_pe(tmp_path, my_index, pe_fastq, backend, 32)
    first = perf.counters()["graphs.captures"]
    assert first == len(backend.graphs) > 0
    perf.reset()
    _run_pe(tmp_path, my_index, pe_fastq, backend, 32)
    assert perf.counters().get("graphs.captures", 0) == 0


def test_profile_dir_trace_holds_both_threads(tmp_path, monkeypatch,
                                              my_index, pe_fastq):
    """The operator's trace (WALTX_PROFILE_DIR) shows the spans of the
    main and the mapper thread as ``waltx.*`` ranges."""
    monkeypatch.setenv("WALTX_PROFILE_DIR", str(tmp_path / "prof"))
    backend = TorchBackend(device="cpu", chunk=64, small_chunk=32)
    _run_pe(tmp_path, my_index, pe_fastq, backend, 64)
    (trace,) = os.listdir(tmp_path / "prof")
    with open(tmp_path / "prof" / trace) as f:
        events = json.load(f)["traceEvents"]
    tids = {}
    for e in events:
        if e.get("ph") == "X" and str(e.get("name", "")).startswith(
                "waltx."):
            tids.setdefault(e["name"], set()).add(e["tid"])
    for name in ("host_parse", "host_emit", "device_map", "backend.sync",
                 "backend.decode", "map_wait"):
        assert "waltx." + name in tids, name
    assert not tids["waltx.host_parse"] & tids["waltx.device_map"]


def test_fallback_masks_match_numpy_concat(fresh_perf):
    """The share the counters give equals the masks' share to the bit."""
    rng = np.random.default_rng(1)
    masks = [rng.random(977) < 0.093 for _ in range(6)]
    perf.count("driver.pairs", sum(m.size for m in masks))
    perf.count("driver.pairs_host", sum(int(m.sum()) for m in masks))
    c = perf.counters()
    pairs, host = c["driver.pairs"], c["driver.pairs_host"]
    assert 100.0 * ((pairs - host) / pairs) == 100.0 * float(
        (~np.concatenate(masks)).mean())
