"""Stage times and a device profile of walt_tpu_torch's SE and PE paths.

Runs on one CUDA GPU, on the data ``chip_smoke.py`` builds (a 128 Mbp
repetitive genome, its index, 1,000,000 x 100 bp reads and 500,000 x 100 bp
read pairs, made once under ``build/smoke_data/``), and prints:

- FASTQ parse + 2-bit pack of all reads (host);
- table setup of the '+' strand table: host prep, upload, uniq run index,
  key16 and u32 word-0 builds (each fenced by a device synchronize);
- ``TorchBackend.map_single_end`` on all reads: the first call (which
  builds both tables) and three steady calls with the tables resident;
- one steady call under ``torch.profiler``: wall, device busy time (the
  union of the device events' intervals), the idle share of the wall, and
  device time by kernel name (the full table goes to ``OUT/``); and one
  more with the host's wall split by the backend's pieces (packing,
  chunk uploads, the graph steps, result copies, waits, the rest);
- the verify stage of one real strand pass (the inputs of the first
  ``verify_worklist`` call of a steady ``map_single_end``): device events
  and device time per pass of the fused kernel against the chain of torch
  ops around K1 that it replaced;
- the CLI end to end with one batch (the default ``-N``) and with 250,000-read
  batches, twice each in turns;
- for the pairs: ``TorchBackend.map_mate_slabs`` on both mates (first call
  with the four table builds, then steady), one steady pair of calls under
  ``torch.profiler`` as above, and the PE CLI with one batch and with
  125,000-pair batches, twice each in turns.

Usage, from the repository root:

    python tools/profile_torch_smoke.py [OUT]

``OUT`` (where the full per-kernel table goes) defaults to
``build/profile/``.
"""

from __future__ import annotations

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(out_dir: str) -> int:
    import torch

    import chip_smoke as cs
    from walt_tpu_torch.constants import get_pattern
    from walt_tpu_torch.host.fastq import FgetsLines, load_batch
    from walt_tpu_torch.index import io_walt
    from walt_tpu_torch.core.torch_backend import TorchBackend
    from walt_tpu_torch.ops import device_index as tdi

    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device("cuda", 0)
    print("card:", cs.card_line(), flush=True)
    idx, fq, pe = cs.build_data(cs.DATA, cs.GENOME_BASES, cs.N_READS,
                                cs.N_PAIRS, cs.READ_LEN)
    pattern = get_pattern("3")
    gm, _ = io_walt.read_head(idx)
    tables = [io_walt.read_table_cached(idx + s, gm)
              for s in ("_CT00", "_CT01")]
    t = time.perf_counter()
    lines = FgetsLines(fq)
    codes, lens = load_batch(lines, 1 << 40).packed()
    lines.close()
    print(f"fastq parse+pack {codes.shape[0]} reads: "
          f"{time.perf_counter() - t:.3f} s", flush=True)

    def sync_t():
        torch.cuda.synchronize(dev)
        return time.perf_counter()

    g, ht = tables[0]
    t0 = sync_t()
    dt = tdi.build_device_table(g, ht, pattern)
    t1 = sync_t()
    d = tdi.place_table(dt, dev)
    t2 = sync_t()
    u = tdi.build_uniq_device(d["pseq"], d["index"], d["counter"], pattern)
    t3 = sync_t()
    k16 = tdi.build_key16_device(d["pseq"], d["index"], pattern)
    t4 = sync_t()
    kw = tdi.build_key_words_device(d["pseq"], d["index"], pattern,
                                    n_key_words=1)
    t5 = sync_t()
    print(f"table setup (one strand, {ht.index.shape[0]} entries): host prep "
          f"{t1 - t0:.3f} s, upload {t2 - t1:.3f} s, uniq {t3 - t2:.3f} s "
          f"(U={u[0].shape[0]}, bits {u[3]}), key16 {t4 - t3:.3f} s, "
          f"word0 {t5 - t4:.3f} s", flush=True)
    del d, u, k16, kw
    torch.cuda.empty_cache()

    be = TorchBackend(device=dev)
    be.table_budget_hint = 2
    t = time.perf_counter()
    be.map_single_end(codes, lens, tables, 5000, 6, pattern)
    print(f"map_single_end first call (builds tables): "
          f"{time.perf_counter() - t:.3f} s", flush=True)
    for rep in range(3):
        be.reset_adaptive()
        t = time.perf_counter()
        r = be.map_single_end(codes, lens, tables, 5000, 6, pattern)
        print(f"map_single_end steady {rep}: {time.perf_counter() - t:.3f} "
              f"s, fallback {r[4].mean():.4f}", flush=True)

    be.reset_adaptive()
    profiled("map_single_end", lambda: be.map_single_end(
        codes, lens, tables, 5000, 6, pattern), dev,
        os.path.join(out_dir, "profile_kernels.txt"))
    be.reset_adaptive()
    host_split(be, lambda: be.map_single_end(codes, lens, tables, 5000, 6,
                                             pattern))
    be.reset_adaptive()
    # a cached step runs its body only while it is captured: drop the
    # backend's graphs, so this call captures (and so runs) its steps again
    be.graphs.clear()
    stage_events(lambda: be.map_single_end(codes, lens, tables, 5000, 6,
                                           pattern))
    be.free_tables()
    # end to end through the CLI: one batch (the default -N) against
    # pipelined 250k-read batches, in turns
    cli_turns(["-r", fq], codes.shape[0], "reads", (1_000_000, 250_000))

    pe_tables = [[io_walt.read_table_cached(idx + s, gm) for s in pair]
                 for pair in (("_CT00", "_CT01"), ("_GA10", "_GA11"))]
    mates = []
    for f in pe:
        lines = FgetsLines(f)
        mates.append(load_batch(lines, 1 << 40).packed())
        lines.close()

    def map_pairs():
        return [be.map_mate_slabs(c, n, tabs, ag, 5000, 6, pattern)
                for (c, n), tabs, ag in zip(mates, pe_tables, (False, True))]

    be = TorchBackend(device=dev)
    be.table_budget_hint = 4
    t = time.perf_counter()
    map_pairs()
    print(f"map_mate_slabs x 2 mates, first call (builds 4 tables): "
          f"{time.perf_counter() - t:.3f} s", flush=True)
    for rep in range(3):
        t = time.perf_counter()
        r = map_pairs()
        print(f"map_mate_slabs x 2 mates steady {rep}: "
              f"{time.perf_counter() - t:.3f} s, pair fallback "
              f"{(r[0][1] | r[1][1]).mean():.4f}", flush=True)
    profiled("map_mate_slabs x 2 mates", map_pairs, dev,
             os.path.join(out_dir, "profile_kernels_pe.txt"))
    be.free_tables()
    cli_turns(["-1", pe[0], "-2", pe[1]], mates[0][0].shape[0], "pairs",
              (500_000, 125_000))
    print("card:", cs.card_line(), flush=True)
    return 0


def host_split(be, call) -> None:
    """Where the host's wall time of one steady ``call()`` of ``be`` goes,
    by timing the backend's pieces on the host clock: packing the batch
    (``packing.pack_codes_np``), making and uploading each chunk (the
    ``_chunks`` generator; a pageable upload waits for the stream), the
    steps (``se_step``: copy into the graph's inputs and replay), starting
    the result copies (``_to_host``), the waits (``_wait``: synchronize and
    numpy), and the rest (phase bookkeeping, unpacking, merges)."""
    from walt_tpu_torch.ops import packing

    spent = dict(pack=0.0, chunks=0.0, steps=0.0, to_host=0.0, wait=0.0)
    n_chunks = [0]

    def timed(name, fn):
        def f(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[name] += time.perf_counter() - t
        return f

    def chunks(*a, **k):
        it = real_chunks(*a, **k)
        while True:
            t = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                spent["chunks"] += time.perf_counter() - t
                return
            spent["chunks"] += time.perf_counter() - t
            n_chunks[0] += 1
            yield item

    real_pack, real_chunks = packing.pack_codes_np, be._chunks
    packing.pack_codes_np = timed("pack", real_pack)
    be._chunks = chunks
    for name, attr in (("steps", "se_step"), ("to_host", "_to_host"),
                       ("wait", "_wait")):
        setattr(be, attr, timed(name, getattr(be, attr)))
    try:
        t = time.perf_counter()
        call()
        wall = time.perf_counter() - t
    finally:
        packing.pack_codes_np = real_pack
        for attr in ("_chunks", "se_step", "_to_host", "_wait"):
            del be.__dict__[attr]
    other = wall - sum(spent.values()) + spent["pack"]
    spent["chunks"] -= spent["pack"]  # the generator packs the batch
    print(f"host split of one steady call: wall {wall * 1e3:.1f} ms; "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in spent.items())
          + f" ({n_chunks[0]} chunks); other {other * 1e3:.1f} ms",
          flush=True)


def stage_events(call) -> None:
    """Device events and device time of the verify stage of one strand
    pass: the fused kernel against the chain it replaced, on the inputs of
    the first ``verify_worklist`` call that ``call()`` makes."""
    import chip_smoke as cs
    from walt_tpu_torch.ops import verify

    seen = []
    real = verify.verify_worklist

    def spy(*a, **kw):
        if not seen:
            seen.append((a, kw))
        return real(*a, **kw)

    verify.verify_worklist = spy
    try:
        call()
    finally:
        verify.verify_worklist = real
    a, kw = seen[0]
    fused = cs.device_profile(lambda: verify.verify_worklist(*a, **kw))
    chain = cs.device_profile(
        lambda: verify.verify_worklist_reference(*a, **kw))
    b_ms, b_by = cs.stage_bound(a, kw)
    print(f"verify stage of one strand pass (M={a[0].shape[0]} rows, "
          f"{float(a[3].float().mean()):.2f} valid, B={a[4].shape[0]} reads, "
          f"W={a[4].shape[1]}): fused kernel {fused[1]:.0f} device events, "
          f"{fused[0] * 1e3:.1f} us; the replaced chain {chain[1]:.0f} device "
          f"events, {chain[0] * 1e3:.1f} us; bound {b_ms * 1e3:.2f} us "
          f"({b_by})", flush=True)


def profiled(label: str, fn, dev, table_path: str) -> None:
    """One call of ``fn`` under torch.profiler: wall, device busy time,
    idle share and device time by kernel name (all rows to
    ``table_path``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from walt_tpu_torch.ops.stages import union_us

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    iv = [(e.time_range.start, e.time_range.end) for e in evs]
    busy = union_us(iv)
    span = (max(e for _, e in iv) - min(s for s, _ in iv)) if iv else 0
    by_name = {}
    for e in evs:
        k = e.name[:80]
        n, tt = by_name.get(k, (0, 0))
        by_name[k] = (n + 1, tt + e.time_range.elapsed_us())
    tot = sum(v[1] for v in by_name.values()) or 1
    print(f"profiled steady {label}: wall {wall * 1e3:.1f} ms, device "
          f"busy {busy / 1e3:.1f} ms (union of device event intervals), "
          f"first-to-last event span {span / 1e3:.1f} ms, idle share of wall "
          f"{1 - busy / 1e6 / wall:.3f}, {len(evs)} device events",
          flush=True)
    rows = [f"{tt / 1e3:9.2f} ms {100 * tt / tot:5.1f}% x{n:5d}  {k}"
            for k, (n, tt) in sorted(by_name.items(),
                                     key=lambda kv: -kv[1][1])]
    print("\n".join(rows[:25]), flush=True)
    with open(table_path, "w") as f:
        f.write("\n".join(rows) + "\n")


def cli_turns(reads_args, n: int, unit: str, batches) -> None:
    """The CLI end to end at each -N of ``batches``, twice, in turns."""
    import chip_smoke as cs
    from walt_tpu_torch import cli

    for n_batch in tuple(batches) * 2:
        out = os.path.join(cs.DATA, f"cli_{unit}_{n_batch}.mr")
        t = time.perf_counter()
        if cli.main(["-i", os.path.join(cs.DATA, "smoke.dbindex"),
                     *reads_args, "-o", out, "-N", str(n_batch)]) != 0:
            raise AssertionError(f"the CLI run with -N {n_batch} failed")
        w = time.perf_counter() - t
        print(f"CLI {unit} -N {n_batch}: {w:.3f} s wall, "
              f"{n / w:.1f} {unit}/s", flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1
                  else os.path.join(REPO, "build", "profile")))
