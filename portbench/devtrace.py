"""The device trace of a window, reduced: busy time, time by device
operation, idle gaps labelled by what the host was doing.

``torch.profiler`` records CPU and CUDA activity over the traced window.
Busy time is the union of the device's operation intervals (kernels,
copies, sets) that fall inside the window; idle is the rest of the window.
A gap in the device's activity takes its label from the program's spans
(``walt_tpu_torch.perf`` stages, kept with their thread by :class:`Spans`)
and the harness's own ranges around its calls into the backend that were
open at the gap's middle.
"""

from __future__ import annotations

import threading
import time


class Spans:
    """Intervals (name, start ns, end ns, thread) of the program's ``perf``
    stages and of the harness's ranges, in ``time.time_ns`` time."""

    def __init__(self):
        self.items = []
        self._lock = threading.Lock()

    def add(self, name: str, seconds: float) -> None:
        end = time.time_ns()
        with self._lock:
            self.items.append((name, end - int(seconds * 1e9), end,
                               threading.get_ident()))

    def wrap(self, name: str, fn):
        def call(*a, **k):
            t0 = time.time_ns()
            try:
                return fn(*a, **k)
            finally:
                self.add(name, (time.time_ns() - t0) / 1e9)
        return call


def _union(intervals):
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce(prof, marker: str, spans: Spans, top: int = 10) -> dict:
    """Reduce a finished profile whose window is the CPU range ``marker``.

    Returns busy_s and window_s (the marker's length), device seconds by
    operation name, and the ``breakdown``'s two lists."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    win = next(e for e in events if e.name() == marker
               and e.device_type() == DeviceType.CPU)
    w0, w1 = win.start_ns(), win.end_ns()
    by_name, iv = {}, []
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        s, z = max(e.start_ns(), w0), min(e.end_ns(), w1)
        if z <= s:
            continue
        iv.append((s, z))
        by_name[e.name()] = by_name.get(e.name(), 0) + (z - s)
    busy = _union(iv)
    busy_ns = sum(z - s for s, z in busy)
    gaps, prev = [], w0
    for s, z in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, z)
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for s, z in gaps[:top]:
        mid = (s + z) // 2
        names = sorted({n for n, a, b, _ in spans.items if a <= mid < b})
        labelled.append(["+".join(names) or "no span", (z - s) / 1e9])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return dict(
        busy_s=busy_ns / 1e9, window_s=(w1 - w0) / 1e9,
        device_ns_by_name=by_name,
        breakdown=dict(device_ops=[[n[:200], v / 1e9] for n, v in ops[:top]],
                       idle_gaps=labelled))
