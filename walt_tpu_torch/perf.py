"""The mapping path's recorder: spans, counters and the profiler trace.

The reference's only tracing is a clock() wrapper macro and a mapping_time
line under -v (util.hpp:80-87, mapping.cpp:524).  Here every pipeline stage
is a span, so a run can say WHERE time went (device dispatch and fetch vs
host fallback vs parse vs emission) -- the numbers that decide batching
and tiering policy (see PERF.md).

- :func:`stage` times one span.  Its seconds are booked through
  :func:`add` into a process-wide table by name (:func:`snapshot`), and
  one record is kept: ``(name, batch, thread id, start_ns, end_ns, cpu_ns,
  parent)`` (:func:`spans`).  ``start_ns``/``end_ns`` are ``time.time_ns``,
  the clock of ``torch.profiler``'s events; ``cpu_ns`` is the thread's
  CPU time in the span (``time.thread_time_ns``); ``parent`` is the name
  of the innermost span open on the same thread, whose batch a span
  without one takes.  At most :data:`MAX_SPANS` records are kept; the
  rest are counted under ``perf.dropped_spans``.
- :func:`count` adds to a named counter (:func:`counters`).
- While a ``torch.profiler`` runs, a span is also the profiler range
  ``waltx.<name>``, so a trace shows the spans beside the kernels.  The
  check is a flag read, made only when torch is loaded.
- ``WALTX_PERF=1`` prints the table and the counters at the end of each
  run (:func:`report`).  ``WALTX_PROFILE_DIR=<dir>`` captures a
  torch.profiler trace of the mapping loop, every thread's host ranges and
  the CUDA kernels when a card is present, as a Chrome trace file in
  <dir> (viewable in Perfetto or chrome://tracing).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

#: records kept before further spans are only counted as dropped
MAX_SPANS = 1 << 20

_stages: dict = defaultdict(float)
_counts: dict = defaultdict(int)
_counters: dict = defaultdict(int)
_records: list = []
_lock = threading.Lock()
_open = threading.local()  # .stack: [(name, batch)] of the thread's spans


def enabled() -> bool:
    return os.environ.get("WALTX_PERF", "") == "1"


def add(stage: str, seconds: float, n: int = 1) -> None:
    _stages[stage] += seconds
    _counts[stage] += n


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counters[name] += n


def _profiling() -> bool:
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and getattr(prof, "_is_profiler_enabled", False)


@contextmanager
def stage(name: str, batch: int | None = None):
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    parent = stack[-1] if stack else (None, None)
    if batch is None:
        batch = parent[1]
    stack.append((name, batch))
    rng = None
    if _profiling():
        # the C-level range: no dispatcher, and the interpreter lock is
        # kept, so it opens and closes within microseconds of the stamps
        from torch._C._profiler import _RecordFunctionFast

        rng = _RecordFunctionFast("waltx." + name)
    t0, c0, s0 = time.perf_counter(), time.thread_time_ns(), time.time_ns()
    if rng is not None:
        rng.__enter__()
    try:
        yield
    finally:
        if rng is not None:
            rng.__exit__(None, None, None)
        s1, c1, t1 = time.time_ns(), time.thread_time_ns(), time.perf_counter()
        stack.pop()
        add(name, t1 - t0)
        rec = (name, batch, threading.get_ident(), s0, s1, c1 - c0,
               parent[0])
        with _lock:
            if len(_records) < MAX_SPANS:
                _records.append(rec)
            else:
                _counters["perf.dropped_spans"] += 1


def spans() -> list:
    """The kept records, oldest first (see the module docstring)."""
    with _lock:
        return list(_records)


def counters() -> dict:
    with _lock:
        return dict(_counters)


def reset() -> None:
    with _lock:
        _stages.clear()
        _counts.clear()
        _counters.clear()
        _records.clear()


def snapshot() -> dict:
    return {k: round(v, 4) for k, v in sorted(_stages.items())}


def report(header: str = "waltx perf") -> None:
    if not _stages and not _counters:
        return
    total = sum(_stages.values())
    print(f"[{header}]", file=sys.stderr)
    for k in sorted(_stages, key=_stages.get, reverse=True):
        v = _stages[k]
        print(
            f"  {k:<28} {v:8.3f}s  {100 * v / max(total, 1e-9):5.1f}%"
            f"  x{_counts[k]}",
            file=sys.stderr,
        )
    for k, v in sorted(counters().items()):
        print(f"  {k:<28} {v:>12}", file=sys.stderr)


_n_traces = 0


@contextmanager
def profiler_trace():
    """torch.profiler capture around the mapping loop (WALTX_PROFILE_DIR):
    one Chrome trace per call, ``waltx_<pid>_<n>.pt.trace.json``, with the
    ranges of every thread (the mapper thread's spans included)."""
    global _n_traces
    d = os.environ.get("WALTX_PROFILE_DIR", "")
    if not d:
        yield
        return
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(d, exist_ok=True)
    _n_traces += 1
    path = os.path.join(d, f"waltx_{os.getpid()}_{_n_traces}.pt.trace.json")
    prof = profile(activities=activities, experimental_config=(
        _ExperimentalConfig(profile_all_threads=True)))
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
        print(f"[waltx profile trace written to {path}]", file=sys.stderr)
