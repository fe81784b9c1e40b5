"""Stage marks of the strand pass, and the recorder that keeps them.

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

The recorder, :class:`StageLog`, keeps the marks in order with their
tensors (the tests hold them to walt_tpu's stage checksums).  It records
an eager step only: a graph replay passes no mark, so ``ops/graphs``
refuses a recorder.  :func:`profiled` and :func:`union_us` read a
``torch.profiler`` trace of whole calls.
"""

from __future__ import annotations

import contextlib
import json
import os
from collections import namedtuple

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
