"""The device trace of a window, reduced: busy time per card, time by
device operation, idle gaps labelled by what the host was doing.

``torch.profiler`` records CPU and CUDA activity over the traced window.
A card's busy time is the union of its own operation intervals (kernels,
copies, sets; keyed by the event's device index) that fall inside the
window, and ``busy_s`` is the mean over the run's cards, so that on a mesh
one card's work does not hide another's idle time.  An idle gap is a
stretch of the window in which no card is busy.  It takes its label from
the program's spans (``walt_tpu_torch.perf`` stages, kept with their
thread by :class:`Spans`) and the harness's own ranges around its calls
into the backend that were open at the gap's middle.
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


def reduce(prof, marker: str, spans: Spans, cards=(), top: int = 10) -> dict:
    """Reduce a finished profile whose window is the CPU range ``marker``
    (see :func:`reduce_events`; ``cards``: the device indices of the run's
    cards)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    win = next(e for e in events if e.name() == marker
               and e.device_type() == DeviceType.CPU)
    return reduce_events([(e.name(), e.device_index(), e.start_ns(),
                           e.end_ns()) for e in events
                          if e.device_type() == DeviceType.CUDA],
                         win.start_ns(), win.end_ns(), spans, cards, top)


def reduce_events(events, w0: int, w1: int, spans: Spans, cards=(),
                  top: int = 10) -> dict:
    """Reduce device events (name, device index, start ns, end ns) over the
    window [w0, w1).

    Returns busy_s (the mean over ``cards``, and any other device that ran
    an operation, of each one's busy seconds), busy_s_by_card, window_s,
    device nanoseconds by operation name (summed over the cards), and the
    ``breakdown``'s two lists."""
    by_name, by_card = {}, {c: [] for c in cards}
    for name, card, s, z in events:
        s, z = max(s, w0), min(z, w1)
        if z <= s:
            continue
        by_card.setdefault(card, []).append((s, z))
        by_name[name] = by_name.get(name, 0) + (z - s)
    busy_ns = {c: sum(z - s for s, z in _union(iv))
               for c, iv in by_card.items()}
    gaps, prev = [], w0
    for s, z in _union(iv for ivs in by_card.values() for iv in ivs) + [
            [w1, w1]]:
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
        busy_s=sum(busy_ns.values()) / (1e9 * max(1, len(busy_ns))),
        busy_s_by_card={f"cuda:{c}": v / 1e9 for c, v in busy_ns.items()},
        window_s=(w1 - w0) / 1e9, device_ns_by_name=by_name,
        breakdown=dict(device_ops=[[n[:200], v / 1e9] for n, v in ops[:top]],
                       idle_gaps=labelled))
