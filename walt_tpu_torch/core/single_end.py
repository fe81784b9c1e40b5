"""Single-end mapping driver (ProcessSingledEndReads, mapping.cpp:421-526).

Differences in HOW (not WHAT): both strand tables stay resident instead of
being re-read from disk every batch (the reference's reload at
mapping.cpp:491-492 exists only to bound RAM), and candidate enumeration is
delegated to a batched backend; the sequential best-hit semantics are then
replayed per read (walt_tpu_torch.host.replay) so the output is byte-identical.
"""

from __future__ import annotations

import itertools
import sys
import time

from walt_tpu_torch import perf
from walt_tpu_torch.constants import get_pattern
from walt_tpu_torch.core import refmap
from walt_tpu_torch.host import emit
from walt_tpu_torch.host.fastq import FgetsLines, load_batch
from walt_tpu_torch.host import replay
from walt_tpu_torch.host.replay import BestMatch, replay_single
from walt_tpu_torch.host.resume import Checkpoint, skip_reads
from walt_tpu_torch.index import io_walt


def process_single_end(index_file: str, reads_file: str, output_file: str,
                       batch_size: int = 10_000_000, max_mismatches: int = 6,
                       b: int = 5000, adaptor: str = "", ag_wildcard: bool = False,
                       ambiguous: bool = False, unmapped: bool = False,
                       sam: bool = False, backend=None, pattern_name: str = "3",
                       verbose: bool = False, resume: bool = False,
                       ckpt_tag: str = "") -> emit.StatSingleReads:
    """``resume``: checkpoint after every batch and, when a matching sidecar
    exists, continue from it instead of remapping (walt_tpu_torch.host.resume)."""
    pattern = get_pattern(pattern_name)
    if backend is None:
        from walt_tpu_torch.core.backends import get_backend

        backend = get_backend("numpy")

    genome_meta, _ = io_walt.read_head(index_file)
    suffixes = ("_CT00", "_CT01") if not ag_wildcard else ("_GA10", "_GA11")
    tables = []
    for s in suffixes:
        with perf.stage("setup.read_table"):
            tables.append(io_walt.read_table_cached(index_file + s,
                                                    genome_meta))
    strands = "+-"
    if hasattr(backend, "table_budget_hint"):
        backend.table_budget_hint = 2  # HBM budget split across both strands

    ckpt = Checkpoint(output_file, [reads_file], ckpt_tag) if resume else None
    resuming = ckpt is not None and ckpt.load()
    if resuming and ckpt.done:
        stat = emit.StatSingleReads()
        if ckpt.stat_dict() is not None:
            from walt_tpu_torch.host.resume import _stat_from_dict

            _stat_from_dict(stat, ckpt.stat_dict())
        return stat

    from walt_tpu_torch.host.directfile import DirectFile

    stat = emit.StatSingleReads()
    fout = DirectFile(output_file, "a")
    famb = funm = None
    if ambiguous and not sam:
        famb = DirectFile(output_file + "_ambiguous", "a" if resuming else "w")
    if unmapped and not sam:
        funm = DirectFile(output_file + "_unmapped", "a" if resuming else "w")
    files = {output_file: fout}
    if famb is not None:
        files[output_file + "_ambiguous"] = famb
    if funm is not None:
        files[output_file + "_unmapped"] = funm

    if verbose:
        print(f"input_file: {reads_file}", file=sys.stderr)
        print(f"output_file: {output_file}", file=sys.stderr)
    if resuming:
        ckpt.restore(stat, files)  # drops any torn batch
    else:
        if ckpt is not None and not ckpt_tag:
            # --resume without a sidecar: a fresh run; clear stale outputs.
            # A tagged run shares its output with earlier runs (one -o for
            # several read files) -- the caller owns truncation then.
            for f in files.values():
                f.truncate(0)
            open(output_file + ".mapstats", "w").close()
        if sam:
            fout.write(emit.sam_head(genome_meta))

    t0 = time.process_time()
    lines = FgetsLines(reads_file)
    reads_done = 0
    if resuming and ckpt.reads_done:
        skip_reads(lines, ckpt.reads_done)
        reads_done = ckpt.reads_done

    if hasattr(backend, "map_single_end"):
        # Device path: seed/refine/verify AND the BestMatch fold run on
        # device (ops/se_fold); only reads the fixed shapes could not hold
        # replay the exact host path.  The loop is software-pipelined with
        # one mapper thread: parse of batch i+1 and emission of batch i-1
        # both hide under the device time of batch i.  (Costs one extra
        # in-flight batch of host memory over the reference's -N bound.)
        import numpy as np
        from concurrent.futures import ThreadPoolExecutor

        def map_batch(batch, i):
            from walt_tpu_torch.core.errors import (
                degraded_batches, is_oom_error,
            )

            with perf.stage("device_map", batch=i):
                codes, lens = batch.packed()
                try:
                    v_pos, v_times, v_minus, v_mm, fb_any = backend.map_single_end(
                        codes, lens, tables, b, max_mismatches, pattern,
                        ag_wildcard
                    )
                except Exception as e:
                    if not is_oom_error(e):
                        raise
                    # device HBM exhausted: remap the whole batch on the
                    # exact host path (byte-identical output) and keep going
                    degraded_batches["se"] += 1
                    print(f"[waltx] device OOM, host-mapping batch of "
                          f"{len(lens)} reads: {e}", file=sys.stderr)
                    n_ = codes.shape[0]
                    v_pos = np.zeros(n_, dtype=np.uint32)
                    v_times = np.zeros(n_, dtype=np.int32)
                    v_minus = np.zeros(n_, dtype=bool)
                    v_mm = np.full(n_, max_mismatches, dtype=np.int32)
                    # too-short reads are never mapped (mapping.cpp:230-233);
                    # their zero defaults already mean "unmapped"
                    fb_any = lens >= pattern.min_read_len
            return codes, lens, v_pos, v_times, v_minus, v_mm, fb_any

        from walt_tpu_torch import native

        def emit_batch(batch, mapped, i):
            codes, lens, v_pos, v_times, v_minus, v_mm, fb_any = mapped

            def replay_one(i):
                return replay_single(
                    [
                        (strand, refmap.enumerate_candidates(
                            codes[i, : int(lens[i])], g, ht, ag_wildcard, b,
                            max_mismatches, pattern))
                        for (g, ht), strand in zip(tables, strands)
                    ],
                    max_mismatches,
                    pattern,
                )

            todo = np.flatnonzero(fb_any)
            perf.count("driver.reads", len(lens))
            perf.count("driver.reads_host", int(todo.size))
            with perf.stage("host_fallback", batch=i):
                got = (
                    native.se_exact(codes[todo], lens[todo], tables,
                                    ag_wildcard, b, max_mismatches, pattern)
                    if todo.size else None
                )
                if got is not None:
                    v_pos[todo], v_times[todo], v_minus[todo], v_mm[todo] = got
                else:
                    for i, bm in zip(todo, replay.host_map(replay_one, todo)):
                        v_pos[i] = bm.genome_pos
                        v_times[i] = bm.times
                        v_minus[i] = bm.strand == "-"
                        v_mm[i] = bm.mismatch
            with perf.stage("host_emit", batch=i):
                emit.write_single_batch(
                    v_pos, v_times, v_minus, v_mm, batch, genome_meta,
                    ag_wildcard, sam, ambiguous, unmapped, fout, famb, funm,
                    stat, pattern.min_read_len,
                )

        # Batch i's spans carry i on both threads; map_wait is the main
        # thread blocked on the mapper.
        def finish(pb, pfut, i):
            nonlocal reads_done
            with perf.stage("map_wait", batch=i):
                mapped = pfut.result()
            emit_batch(pb, mapped, i)
            reads_done += len(pb)
            if ckpt is not None:
                ckpt.save(stat, files, reads_done)

        with ThreadPoolExecutor(1) as ex, perf.profiler_trace():
            prev = None
            for i in itertools.count():
                with perf.stage("host_parse", batch=i):
                    batch = load_batch(lines, batch_size, adaptor.encode())
                n = len(batch)
                fut = ex.submit(map_batch, batch, i) if n else None
                if prev is not None:
                    finish(*prev)
                prev = (batch, fut, i) if n else None
                if n < batch_size:
                    break
            if prev is not None:
                finish(*prev)
        lines.close()
        fout.close()
        for f in (famb, funm):
            if f is not None:
                f.close()
        with open(output_file + ".mapstats", "a") as ms:
            ms.write(stat.tostring(pattern.min_read_len) + "\n")
        if ckpt is not None:
            ckpt.save(stat, {}, reads_done, done=True)
        if perf.enabled():
            perf.report(f"waltx perf SE {reads_file}")
        if verbose:
            print(f"mapping_time: {time.process_time() - t0}", file=sys.stderr)
        return stat

    while True:
        batch = load_batch(lines, batch_size, adaptor.encode())
        n = len(batch)
        if n == 0:
            break
        codes, lens = batch.packed()

        streams = []
        for (g, ht), strand in zip(tables, strands):
            per_read = backend.map_strand(
                codes, lens, g, ht, ag_wildcard, b, max_mismatches, pattern
            )
            streams.append((strand, per_read))

        for j in range(n):
            if int(lens[j]) < pattern.min_read_len:
                # counted once per strand pass (mapping.cpp:230-233 runs
                # under both table iterations of mapping.cpp:491-499)
                stat.num_of_short += 2
                bm = BestMatch(0, 0, "+", max_mismatches)
            else:
                bm = replay_single(
                    [(strand, per_read[j]) for strand, per_read in streams],
                    max_mismatches,
                    pattern,
                )
            stat.update(bm.times)
            if not sam:
                emit.single_mr(
                    bm, batch.names[j], batch.seqs[j], batch.quals[j],
                    genome_meta, ag_wildcard, fout, famb, funm,
                )
            else:
                emit.single_sam(
                    bm, batch.names[j], batch.seqs[j], batch.quals[j],
                    genome_meta, ambiguous, unmapped, fout,
                )

        reads_done += n
        if ckpt is not None:
            ckpt.save(stat, files, reads_done)
        if n < batch_size:
            break
    lines.close()
    fout.close()
    for f in (famb, funm):
        if f is not None:
            f.close()

    with open(output_file + ".mapstats", "a") as ms:
        ms.write(stat.tostring(pattern.min_read_len) + "\n")
    if ckpt is not None:
        ckpt.save(stat, {}, reads_done, done=True)
    if verbose:
        print(f"mapping_time: {time.process_time() - t0}", file=sys.stderr)
    return stat
