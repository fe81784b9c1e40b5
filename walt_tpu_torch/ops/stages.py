"""Stage marks of the strand pass, and the CUDA timer that reads them.

Takes the place of walt_tpu's stage-truncation profiler (the ``stage_out``
checksums in ``walt_tpu/ops/pipeline.py`` and ``map_strand_stage``, timed
by ``tools/device_profile.py``), which compiled the pass cut short after
each stage.  Here the pass runs whole: ``pipeline.map_strand_core`` calls
``stages.mark(name, **live)`` at each stage boundary, ``live`` holding the
tensors alive there.  The stages of one strand pass, in order
(:data:`STRAND_STAGES`):

- ``keys``: read conversion, cared-base extraction, hash keys, the bucket
  bounds ``lo``/``hi`` and ``flagged``, the prefix words and masks, and on a
  routed tp shard the route compaction;
- ``search``: the ``_binary_lower`` chains (entry, key16 or uniq path);
- ``membership``: slab admission;
- ``worklist``: the cumsum/scatter compaction to M rows;
- ``verify``: the one ``verify.verify_worklist`` launch.  walt_tpu's
  worklist stage also held the index gather, the chromosome search and
  ``ok_head``/``ok_tail``; the fused kernel does them, so they count here;
- ``compact``: each kept row's ordered rank, the capped counts, the
  fallback bits and the three slab scatters.  With ``emit_wl`` (the PE
  mate step) the pass returns the worklist instead, without the scatters,
  and marks ``compact`` there: its ranks and fallback bits are device work
  of the pass that no other stage holds.

The device steps wrap each strand pass in :func:`strand_pass` (``begin``
with the pass's table index, then ``end``) and mark one step stage after
both passes: ``fold`` (``se_fold.map_single_end_device``) or ``flat``
(``pe_map.map_mate_device``).  With ``stages=None`` nothing is recorded:
no event, no profiler range, no host synchronization.

Recorders: :class:`StageLog` keeps the marks in order with their tensors
(the tests hold them to walt_tpu's stage checksums);
:class:`CudaStageTimer` records a CUDA event at each boundary and opens a
``torch.profiler.record_function`` range per stage, so a profiled call
gives each stage's device busy time and launches
(:meth:`CudaStageTimer.device_split`).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
from collections import Counter, namedtuple

import torch

#: the stages of one strand pass, in mark order
STRAND_STAGES = ("keys", "search", "membership", "worklist", "verify",
                 "compact")
#: the stage each device step marks after its strand passes
SE_STEP_STAGE = "fold"
PE_STEP_STAGE = "flat"
#: trace categories of device work, and of the host calls that launch it
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: names of the host calls that put work on the device (each has one
#: device record when the profiler kept it)
LAUNCH_WORDS = ("LaunchKernel", "Memcpy", "Memset")

#: one mark: the strand pass's number in its recorder and its table index
#: (both None for a step stage), the stage name, and the live tensors
Mark = namedtuple("Mark", "pass_no table name live")


def _no_mark(name, **live):
    """The mark of ``stages=None``: records nothing."""


def marker(stages):
    """``stages.mark``, or a function that does nothing when ``stages`` is
    None."""
    return _no_mark if stages is None else stages.mark


def strand_pass(stages, table: int):
    """Context of one strand pass against table ``table`` of a device step
    (``stages.begin(table)`` ... ``stages.end()``); nothing when ``stages``
    is None."""
    return contextlib.nullcontext() if stages is None else \
        stages.strand(table)


class StageLog:
    """The marks of a run, in order, with their live tensors."""

    def __init__(self):
        self.marks = []
        self._open = None  # (pass_no, table) of the open strand pass
        self._passes = 0

    @contextlib.contextmanager
    def strand(self, table: int):
        self.begin(table)
        yield self
        self.end()

    def begin(self, table: int) -> None:
        if self._open is not None:
            raise RuntimeError("stages: a strand pass is already open")
        self._open = (self._passes, table)
        self._passes += 1

    def end(self) -> None:
        if self._open is None:
            raise RuntimeError("stages: no strand pass is open")
        self._open = None

    def mark(self, name: str, **live) -> None:
        pass_no, table = self._open or (None, None)
        self.marks.append(Mark(pass_no, table, name, live))

    def names(self) -> list:
        """[(table, stage)] in mark order (table None for a step stage)."""
        return [(m.table, m.name) for m in self.marks]


def _put(out: dict, key, value) -> None:
    if key in out:
        raise RuntimeError(f"stages: {key} recorded twice; use one "
                           f"recorder per device step")
    out[key] = value


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


class CudaStageTimer(StageLog):
    """Stream time per stage from CUDA events, and the ranges that give
    device busy time and launches per stage under ``torch.profiler``.

    At ``begin``, each mark and ``end`` it records a
    ``torch.cuda.Event(enable_timing=True)`` on the device's current
    stream; nothing waits for them.  Each stretch between two boundaries
    runs inside its own ``record_function`` range (the range of a stage
    ends at its mark; a pass's stretch after its last mark and the
    stretches between passes have no stage), and each strand pass inside
    one more range; a step stage's mark ends the timer's ranges.  One timer
    records one device-step call.  It keeps no tensor of the marks, so it
    holds no device memory.
    """

    def __init__(self, device=None):
        super().__init__()
        self.device = torch.device(
            "cuda", torch.cuda.current_device()) if device is None \
            else torch.device(device)
        # distinct for the timers alive in one profiling window
        self._prefix = f"waltx_stage.{id(self):x}."
        self._bounds = []  # (Mark or ("begin"|"end", pass_no, table), event)
        self._segments = {}  # range name -> (pass_no, table, stage or None)
        self._pass_ranges = {}  # range name -> (pass_no, table)
        self._seg = None  # (name, range, pass_no, table) of the open stretch
        self._pass_range = None
        self._n_seg = 0

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _open_segment(self, pass_no, table) -> None:
        name = f"{self._prefix}s{self._n_seg}"
        self._n_seg += 1
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        self._seg = (name, rf, pass_no, table)

    def _close_segment(self, stage) -> None:
        if self._seg is None:
            return
        name, rf, pass_no, table = self._seg
        rf.__exit__(None, None, None)
        self._segments[name] = (pass_no, table, stage)
        self._seg = None

    def begin(self, table: int) -> None:
        super().begin(table)
        pass_no = self._open[0]
        self._close_segment(None)  # between passes: no stage
        self._bounds.append((("begin", pass_no, table), self._event()))
        name = f"{self._prefix}p{pass_no}"
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        self._pass_range = rf
        self._pass_ranges[name] = (pass_no, table)
        self._open_segment(pass_no, table)

    def end(self) -> None:
        pass_no, table = self._open or (None, None)
        super().end()  # raises when no pass is open
        self._bounds.append((("end", pass_no, table), self._event()))
        self._close_segment(None)  # after the pass's last mark: no stage
        self._pass_range.__exit__(None, None, None)
        self._pass_range = None
        self._open_segment(None, None)

    def mark(self, name: str, **live) -> None:
        if self._seg is None:
            raise RuntimeError(f"stages: mark {name!r} before any strand "
                               f"pass")
        super().mark(name)  # without the tensors
        m = self.marks[-1]
        self._bounds.append((m, self._event()))
        self._close_segment(name)
        if m.pass_no is not None:
            self._open_segment(m.pass_no, m.table)

    def stream_ms(self) -> dict:
        """{(table, stage): ms} from each mark's event back to the boundary
        before it, and {(table, "strand"): ms} from each pass's ``begin``
        to its ``end``.  Call after the device was synchronized once."""
        out, start, prev = {}, {}, None
        for what, ev in self._bounds:
            if isinstance(what, Mark):
                _put(out, (what.table, what.name), prev.elapsed_time(ev))
            elif what[0] == "begin":
                start[what[1]] = ev
            else:
                _put(out, (what[2], "strand"),
                     start[what[1]].elapsed_time(ev))
            prev = ev
        return out

    def device_split(self, events) -> dict:
        """Device work of the recorded call, by the stage that launched it.

        ``events``: the chrome-trace events of a ``torch.profiler`` run
        (CPU and CUDA activities) around the call.  Each device event
        (kernel, copy, fill) is matched to the host call that launched it
        by the profiler's correlation id, and belongs to the range that
        holds that call on the host timeline, not to the range its device
        time overlaps (the device runs a kernel later than its launch).

        Returns {(table, stage): dict(busy_ms, launches, names, dropped)}
        for every mark, {(table, "strand"): ...} for every pass (all device
        work its range launched), and {(None, None): ...} for device work
        launched in this recorder's ranges outside any stage (after a
        pass's last mark, or between passes); ``busy_ms`` is the union of
        the device intervals, ``names`` a Counter of device event names,
        ``dropped`` the host launch calls of the range whose device record
        the trace lacks (the profiler lost it; the numbers are then short).
        """
        self._close_segment(None)  # the step's calls are over
        segs, passes = [], []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") != "user_annotation":
                continue
            span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            if e["name"] in self._segments:
                segs.append(span + (self._segments[e["name"]],))
            elif e["name"] in self._pass_ranges:
                passes.append(span + (self._pass_ranges[e["name"]],))
        segs.sort(key=lambda s: s[:2])
        passes.sort(key=lambda s: s[:2])
        launched = {}
        for e in events:
            corr = e.get("args", {}).get("correlation")
            if e.get("cat") in LAUNCH_CATS and corr is not None:
                launched.setdefault(corr, (float(e["ts"]), e["name"]))
        groups, recorded = {}, set()

        def keys_at(ts):
            seg = _holding(segs, ts)
            if seg is None:
                return []  # launched outside this recorder's ranges
            pass_no, table, stage = seg
            keys = [(None, None) if stage is None else (table, stage)]
            pas = _holding(passes, ts)
            return keys + ([] if pas is None else [(pas[1], "strand")])

        for e in events:
            corr = e.get("args", {}).get("correlation")
            if e.get("cat") not in DEVICE_CATS or corr not in launched:
                continue
            recorded.add(corr)
            span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for key in keys_at(launched[corr][0]):
                groups.setdefault(key, dict(spans=[], names=Counter(),
                                            dropped=0))
                groups[key]["spans"].append(span)
                groups[key]["names"][e["name"]] += 1
        for corr, (ts, name) in launched.items():
            if corr in recorded or not any(w in name for w in LAUNCH_WORDS):
                continue
            for key in keys_at(ts):
                groups.setdefault(key, dict(spans=[], names=Counter(),
                                            dropped=0))
                groups[key]["dropped"] += 1
        return {k: dict(busy_ms=union_us(g["spans"]) / 1e3,
                        launches=len(g["spans"]), names=g["names"],
                        dropped=g["dropped"])
                for k, g in groups.items()}


def _holding(spans, ts):
    """The payload of the (start, end, payload) span that holds ``ts``
    (``spans`` sorted and disjoint), or None."""
    i = bisect.bisect_right(spans, (ts, float("inf"))) - 1
    if i >= 0 and spans[i][0] <= ts <= spans[i][1]:
        return spans[i][2]
    return None


def device_events(events) -> int:
    """Device events (kernels, copies, fills) of a trace."""
    return sum(1 for e in events if e.get("cat") in DEVICE_CATS)


def unmatched_device_events(events) -> int:
    """Device events of a trace whose launching host call the trace does
    not hold (their stage cannot be known)."""
    launched = {e.get("args", {}).get("correlation") for e in events
                if e.get("cat") in LAUNCH_CATS}
    return sum(1 for e in events if e.get("cat") in DEVICE_CATS
               and e.get("args", {}).get("correlation") not in launched)


def profiled(fn, warmup, trace_path: str):
    """(fn(), trace events): one call of ``fn`` under ``torch.profiler``
    (CPU and CUDA activities), the device synchronized inside the window;
    the chrome trace is written to ``trace_path`` and read back.

    ``warmup()`` runs first, in the profiler's warm-up step (tracing on,
    records discarded): on an H100 the first device records after tracing
    starts went missing while their host launch records stayed (36 of a
    call's first launches in one window, 1 in the next ones)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    os.makedirs(os.path.dirname(os.path.abspath(trace_path)), exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(trace_path)
                 ) as prof:
        warmup()
        torch.cuda.synchronize()
        prof.step()
        out = fn()
        torch.cuda.synchronize()
        prof.step()
    with open(trace_path) as f:
        return out, json.load(f)["traceEvents"]
