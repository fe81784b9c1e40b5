"""The program's spans on a card: their clock against the profiler's, the
backend's cover of ``device_map``, and what a span costs.

Runs one traced window of a benchmark cell through ``portbench``'s harness
(set-up, warm-up and window as ``portbench/run.py --trace 1`` makes them),
with the profiler recording every thread, so the mapper thread's spans are
ranges too.  Then, from the window's ``walt_tpu_torch.perf`` records:

- each ``waltx.<name>`` range of the profiler against its span's own
  ``time_ns`` stamps: the start and end offsets by thread (main, mapper),
  their median, 99th percentile and extremes;
- per full batch, the share of ``device_map``'s wall time that its
  children (``backend.pack``, ``launch``, ``sync``, ``decode``) cover, and
  the largest remainder;
- the cost of one span with no profiler, and with one running.

One JSON object goes to standard output and to ``OUT`` (default
``build/trace_check.json``).  Usage, from the repository root:

    python tools/trace_check_torch.py [--workload athal_p3.pe2x100]
        [--seed 1] [--seconds 30] [--out OUT] [--root ROOT]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CHILDREN = ("backend.pack", "backend.launch", "backend.sync",
            "backend.decode")


def span_cost(n: int = 200_000) -> dict:
    """Microseconds per empty span, and per counter, with no profiler and
    inside a CPU profiler window."""
    from torch.profiler import ProfilerActivity, profile

    from walt_tpu_torch import perf

    def loop(k):
        t = time.perf_counter()
        for _ in range(k):
            with perf.stage("cost"):
                pass
        return (time.perf_counter() - t) / k * 1e6

    perf.reset()
    off = loop(n)
    t = time.perf_counter()
    for _ in range(n):
        perf.count("cost")
    counter = (time.perf_counter() - t) / n * 1e6
    perf.reset()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    on = loop(n // 20)
    prof.stop()
    perf.reset()
    return dict(span_us=off, counter_us=counter, span_profiled_us=on)


def offsets(events, recs, main_tid) -> dict:
    """Range start less span start, and span end less range end, in
    microseconds, by thread: median, 99th percentile, smallest and largest
    (each range matched to the record of its name it overlaps most; the
    span's stamps are taken outside its range, so both read >= 0)."""
    by_name = {}
    for r in recs:
        by_name.setdefault(r[0], []).append(r)
    got = {}
    unmatched = 0
    for name, a, z in events:
        best = None
        for r in by_name.get(name, ()):
            ov = min(z, r[4]) - max(a, r[3])
            if ov > 0 and (best is None or ov > best[0]):
                best = (ov, r)
        if best is None:
            unmatched += 1
            continue
        r = best[1]
        side = got.setdefault("main" if r[2] == main_tid else "mapper",
                              ([], []))
        side[0].append((a - r[3]) / 1e3)
        side[1].append((r[4] - z) / 1e3)

    def summary(v):
        v = sorted(v)
        return dict(median=statistics.median(v), p99=v[int(0.99 * len(v))],
                    min=v[0], max=v[-1], over_200us=sum(x > 200 for x in v))

    named = {r[0] for r in recs}
    return dict(by_thread={k: dict(ranges=len(s), start_us=summary(s),
                                   end_us=summary(e))
                           for k, (s, e) in got.items()},
                unmatched_ranges=unmatched,
                spans_without_range=sorted(named - {e[0] for e in events}))


def cover(recs) -> dict:
    """Per batch holding a ``host_emit``: the children's share of
    ``device_map``'s wall time; over all of them, the wall and thread CPU
    time that no child covers (CPU time near 0: the thread was waiting),
    and the longest such stretches, each with the children around it."""
    by_batch = {}
    for r in recs:
        by_batch.setdefault(r[1], []).append(r)
    shares, rests, rest_cpu, gaps = [], [], [], []
    for b, rs in sorted(by_batch.items(), key=lambda kv: str(kv[0])):
        dm = [r for r in rs if r[0] == "device_map"]
        if b is None or len(dm) != 1 or not any(r[0] == "host_emit"
                                                for r in rs):
            continue
        wall = dm[0][4] - dm[0][3]
        kids = sorted((r[3], r[4], r[0]) for r in rs
                      if r[6] == "device_map")
        shares.append(sum(z - a for a, z, _ in kids) / wall)
        rests.append((wall - sum(z - a for a, z, _ in kids)) / 1e6)
        rest_cpu.append((dm[0][5] - sum(r[5] for r in rs
                                        if r[6] == "device_map")) / 1e6)
        prev, prev_name = dm[0][3], "start"
        for a, z, name in kids + [(dm[0][4], dm[0][4], "end")]:
            gaps.append(((a - prev) / 1e6, prev_name, name, b))
            prev, prev_name = z, name
    by_child = {c: sum(r[4] - r[3] for r in recs if r[0] == c) / 1e9
                for c in CHILDREN}
    gaps.sort(reverse=True)
    return dict(batches=len(shares), shares=[round(x, 4) for x in shares],
                min_share=min(shares, default=None),
                median_share=statistics.median(shares) if shares else None,
                max_rest_ms=max(rests, default=None),
                rest_ms=sum(rests), rest_cpu_ms=sum(rest_cpu),
                child_s=by_child,
                longest_gaps_ms=[list(g) for g in gaps[:8]])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", default="athal_p3.pe2x100")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--out", default=os.path.join(ROOT, "build",
                                                 "trace_check.json"))
    p.add_argument("--root", default=ROOT,
                   help="the checkout whose BENCHMARK.json names the cell")
    args = p.parse_args(argv)
    import torch
    import torch.profiler
    from torch._C._profiler import _ExperimentalConfig

    from portbench import devtrace, harness
    from walt_tpu_torch import perf

    real_profile = torch.profiler.profile

    def all_threads(*a, **k):
        k.setdefault("experimental_config",
                     _ExperimentalConfig(profile_all_threads=True))
        return real_profile(*a, **k)

    torch.profiler.profile = all_threads
    seen = {}
    real_reduce = devtrace.reduce

    def reduce(prof, marker, spans, top=10):
        from torch.autograd import DeviceType

        seen["ranges"] = [
            (e.name()[6:], e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU
            and e.name().startswith("waltx.")]
        seen["records"] = perf.spans()
        return real_reduce(prof, marker, spans, top)

    devtrace.reduce = reduce
    device = "cuda" if torch.cuda.is_available() else "cpu"
    result, info = harness.run_cell(args.root, args.workload, args.seed,
                                    args.seconds, True, device, T_START)
    torch.profiler.profile = real_profile
    devtrace.reduce = real_reduce
    recs = seen["records"]
    main_tid = next(r[2] for r in recs if r[0] == "host_parse")
    got = dict(
        workload=args.workload, seed=args.seed, device=device,
        card=torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
        torch=torch.__version__, correct=result["correct"],
        fed=info["fed"], window_s=info["window_s"],
        records=len(recs), counters=perf.counters(),
        metrics={k: v["value"] for k, v in result["metrics"].items()},
        offsets=offsets(seen["ranges"], recs, main_tid),
        device_map_cover=cover(recs), cost=span_cost())
    text = json.dumps(got, indent=1, default=str)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
