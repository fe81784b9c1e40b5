"""Paired-end mapping driver (ProcessPairedEndReads, paired.cpp:572-713).

Mate 1 is mapped C->T against the CT tables, mate 2 G->A against the GA
tables (paired.cpp:592-596, 642-643).  Per mate the top-k candidates are kept
with the reference's bounded heap semantics (replayed on host), then pairs
are joined under the opposite-strand / same-chromosome / fragment-length
constraints of MergePairedEndResults (paired.cpp:438-570).
"""

from __future__ import annotations

import itertools
import sys
import time

import numpy as np

from walt_tpu_torch import perf
from walt_tpu_torch.constants import get_pattern
from walt_tpu_torch.host import emit, emit_paired
from walt_tpu_torch.host.fastq import FgetsLines, load_batch
from walt_tpu_torch.host.replay import (
    BestMatch,
    get_best_match_for_single,
    replay_paired_topk,
)
from walt_tpu_torch.host.resume import Checkpoint, skip_reads
from walt_tpu_torch.index import io_walt


def extract_adaptors(adaptor: str):
    """'T_adaptor[:A_adaptor]' (util.hpp:221-233)."""
    if adaptor.count(":") > 1:
        raise RuntimeError('ERROR: adaptor format "T_adaptor[:A_adaptor]"')
    if ":" not in adaptor:
        return adaptor, adaptor
    t, a = adaptor.split(":")
    return t, a


def merge_pair(genome, ranked1, ranked2, name, seq1, qual1, seq2, qual2,
               frag_range, max_mismatches, sam, stat, fouts, pattern,
               pbat=False):
    """MergePairedEndResults (paired.cpp:438-570).

    ranked1/ranked2: drain-order candidate lists (mm, pos, strand).
    fouts: dict with 'out', and per-mate ambiguous/unmapped handles or None.
    """
    len1, len2 = len(seq1), len(seq2)
    best_pair = (-1, -1)
    min_mm = max_mismatches
    best_pos = 0
    best_times = 0
    n1, n2 = len(ranked1), len(ranked2)
    for i in range(n1 - 1, -1, -1):
        r1 = ranked1[i]
        chr_id1 = int(genome.chrom_id_of(r1[1]))
        for j in range(n2 - 1, -1, -1):
            r2 = ranked2[j]
            if r1[2] == r2[2]:
                continue
            mm = r1[0] + r2[0]
            if mm > min_mm:
                break
            chr_id2 = int(genome.chrom_id_of(r2[1]))
            if chr_id1 != chr_id2:
                continue
            frag = emit_paired.fragment_length(
                genome, r1, r2, len1, len2, chr_id1, chr_id2
            )
            if frag <= 0 or frag > frag_range:
                continue
            cur_pos = (r1[1] << 32) + r2[1]
            if mm < min_mm:
                best_pair = (i, j)
                best_times = 1
                min_mm = mm
                best_pos = cur_pos
            elif mm == min_mm and cur_pos != best_pos:
                best_pair = (i, j)
                best_times += 1

    bm1 = BestMatch(0, 0, "+", max_mismatches)
    bm2 = BestMatch(0, 0, "+", max_mismatches)
    is_paired_mapped = False
    frag_len = 0
    if best_times == 1:
        stat.unique_pairs += 1
        r1, r2 = ranked1[best_pair[0]], ranked2[best_pair[1]]
        frag_len = emit_paired.best_paired_mr(
            genome, r1, r2, frag_range, name, seq1, qual1, seq2, qual2,
            sam, fouts["out"],
        )
        stat.frag_len_count[frag_len] += 1
        if sam:
            is_paired_mapped = True
            bm1 = BestMatch(r1[1], 1, r1[2], r1[0])
            bm2 = BestMatch(r2[1], 1, r2[2], r2[0])
    else:
        if best_times >= 2:
            stat.ambiguous_pairs += 1
        else:
            stat.unmapped_pairs += 1
        bm1 = get_best_match_for_single(ranked1, max_mismatches)
        bm2 = get_best_match_for_single(ranked2, max_mismatches)
        stat.mate1.update(bm1.times)
        stat.mate2.update(bm2.times)
        if not sam:
            emit.single_mr(
                bm1, name, seq1, qual1, genome, pbat,
                fouts["out"], fouts["amb1"], fouts["unm1"],
            )
            emit.single_mr(
                bm2, name, seq2, qual2, genome, not pbat,
                fouts["out"], fouts["amb2"], fouts["unm2"],
            )
    if sam:
        flag1 = emit_paired.sam_flag(
            True, is_paired_mapped, bm1.times == 0, bm2.times == 0,
            bm1.strand == "-", bm2.strand == "-", True, False, bm1.times >= 2,
        )
        flag2 = emit_paired.sam_flag(
            True, is_paired_mapped, bm2.times == 0, bm1.times == 0,
            bm2.strand == "-", bm1.strand == "-", False, True, bm2.times >= 2,
        )
        emit_paired.paired_sam(
            bm1, bm2, genome, name, seq1, qual1, seq2, qual2, frag_len,
            flag1, flag2, fouts["ambiguous"], fouts["unmapped"],
            fouts["ambiguous"], fouts["unmapped"], fouts["out"],
        )


def _emit_pair_finalized(genome, i, fin, name, seq1, qual1, seq2, qual2,
                         frag_range, max_mismatches, sam, stat, fouts,
                         pbat=False):
    """Emission for one pair from the native finalizer's arrays.

    Byte-identical to :func:`merge_pair` fed the same candidate streams; the
    heap replay / pair join already happened in walt_tpu_torch.native.
    """
    code = int(fin["code"][i])
    sc = "+-"
    bm1 = BestMatch(int(fin["bm_pos"][2 * i]), int(fin["bm_times"][2 * i]),
                    sc[fin["bm_strand"][2 * i]], int(fin["bm_mm"][2 * i]))
    bm2 = BestMatch(int(fin["bm_pos"][2 * i + 1]), int(fin["bm_times"][2 * i + 1]),
                    sc[fin["bm_strand"][2 * i + 1]], int(fin["bm_mm"][2 * i + 1]))
    is_paired_mapped = False
    frag_len = 0
    if code == 0:
        stat.unique_pairs += 1
        r1 = (int(fin["r1_mm"][i]), int(fin["r1_pos"][i]), sc[fin["r1_strand"][i]])
        r2 = (int(fin["r2_mm"][i]), int(fin["r2_pos"][i]), sc[fin["r2_strand"][i]])
        frag_len = emit_paired.best_paired_mr(
            genome, r1, r2, frag_range, name, seq1, qual1, seq2, qual2,
            sam, fouts["out"],
        )
        stat.frag_len_count[frag_len] += 1
        is_paired_mapped = sam
    else:
        if code == 1:
            stat.ambiguous_pairs += 1
        else:
            stat.unmapped_pairs += 1
        stat.mate1.update(bm1.times)
        stat.mate2.update(bm2.times)
        if not sam:
            emit.single_mr(bm1, name, seq1, qual1, genome, pbat,
                           fouts["out"], fouts["amb1"], fouts["unm1"])
            emit.single_mr(bm2, name, seq2, qual2, genome, not pbat,
                           fouts["out"], fouts["amb2"], fouts["unm2"])
    if sam:
        flag1 = emit_paired.sam_flag(
            True, is_paired_mapped, bm1.times == 0, bm2.times == 0,
            bm1.strand == "-", bm2.strand == "-", True, False, bm1.times >= 2,
        )
        flag2 = emit_paired.sam_flag(
            True, is_paired_mapped, bm2.times == 0, bm1.times == 0,
            bm2.strand == "-", bm1.strand == "-", False, True, bm2.times >= 2,
        )
        emit_paired.paired_sam(
            bm1, bm2, genome, name, seq1, qual1, seq2, qual2, frag_len,
            flag1, flag2, fouts["ambiguous"], fouts["unmapped"],
            fouts["ambiguous"], fouts["unmapped"], fouts["out"],
        )


def process_paired_end(index_file: str, reads_file_1: str, reads_file_2: str,
                       output_file: str, batch_size: int = 10_000_000,
                       max_mismatches: int = 6, b: int = 5000, adaptor: str = "",
                       top_k: int = 50, frag_range: int = 1000,
                       ambiguous: bool = False, unmapped: bool = False,
                       sam: bool = False, backend=None, pattern_name: str = "3",
                       verbose: bool = False, pbat: bool = False,
                       resume: bool = False,
                       ckpt_tag: str = "") -> emit.StatPairedReads:
    """``pbat``: PBAT libraries swap the mates' conversion roles (mate 1
    maps G->A against the GA tables, mate 2 C->T) -- an extension; the
    reference documents -P (README.md:100-104) but does not implement it."""
    pattern = get_pattern(pattern_name)
    if backend is None:
        from walt_tpu_torch.core.backends import get_backend

        backend = get_backend("numpy")

    genome_meta, _ = io_walt.read_head(index_file)
    table_names = [("_CT00", "_CT01"), ("_GA10", "_GA11")]
    if pbat:
        table_names.reverse()
    tables = []
    for pair in table_names:
        tables.append([])
        for s in pair:
            with perf.stage("setup.read_table"):
                tables[-1].append(io_walt.read_table_cached(index_file + s,
                                                            genome_meta))
    strands = "+-"
    if hasattr(backend, "table_budget_hint"):
        backend.table_budget_hint = 4  # HBM budget split across all 4 tables

    stat = emit.StatPairedReads(
        frag_len_count=np.zeros(frag_range + 1, dtype=np.int64)
    )
    adaptors = extract_adaptors(adaptor)

    ckpt = (
        Checkpoint(output_file, [reads_file_1, reads_file_2], ckpt_tag)
        if resume else None
    )
    resuming = ckpt is not None and ckpt.load()
    if resuming and ckpt.done:
        if ckpt.stat_dict() is not None:
            from walt_tpu_torch.host.resume import _stat_from_dict

            _stat_from_dict(stat, ckpt.stat_dict())
        return stat

    from walt_tpu_torch.host.directfile import DirectFile

    fout = DirectFile(output_file, "a")
    fouts = {"out": fout, "ambiguous": ambiguous, "unmapped": unmapped}
    files = {output_file: fout}
    for mate in (1, 2):
        for kind, enabled in (("ambiguous", ambiguous), ("unmapped", unmapped)):
            key = f"{kind[:3]}{mate}"
            path = f"{output_file}_{mate}_{kind}"
            f = DirectFile(path, "a" if resuming else "w") if (
                enabled and not sam
            ) else None
            fouts[key] = f
            if f is not None:
                files[path] = f

    print("[MAPPING PAIRED-END READS FROM THE FOLLOWING TWO FILES]", file=sys.stderr)
    print(f"   {reads_file_1} (AND)\n   {reads_file_2}", file=sys.stderr)
    print(f"[OUTPUT MAPPING RESULTS TO {output_file}]", file=sys.stderr)
    if resuming:
        ckpt.restore(stat, files)  # drops any torn batch
    else:
        if ckpt is not None and not ckpt_tag:
            # fresh tagged runs share the output; the caller owns truncation
            for f in files.values():
                f.truncate(0)
            open(output_file + ".mapstats", "w").close()
        if sam:
            fout.write(emit.sam_head(genome_meta))

    from walt_tpu_torch import native

    use_native = (
        native.get_lib() is not None and hasattr(backend, "map_mate_slabs")
    )

    t0 = time.process_time()
    lines = [FgetsLines(reads_file_1), FgetsLines(reads_file_2)]
    pairs_done = 0
    if resuming and ckpt.reads_done:
        for ln in lines:
            skip_reads(ln, ckpt.reads_done)
        pairs_done = ckpt.reads_done

    def parse_pair(i=None):
        """Load batch ``i`` of both mates (paired.cpp:648, 673-677)."""
        with perf.stage("host_parse", batch=i):
            b1 = load_batch(lines[0], batch_size, adaptors[0].encode())
            b2 = load_batch(lines[1], batch_size, adaptors[1].encode())
        if len(b1) != len(b2):
            raise RuntimeError(
                "The number of reads in paired-end files should be the same."
            )
        return b1, b2

    def map_pair(b1, b2, i):
        """Device map of batch ``i``'s mates, on the mapper thread: all
        dispatches in flight before the first fetch (fused strand programs,
        ops/pe_map)."""
        from walt_tpu_torch.core.errors import (
            degraded_batches, is_oom_error,
        )

        with perf.stage("device_map", batch=i):
            lens_by_mate = [batch.packed()[1] for batch in (b1, b2)]
            try:
                handles = []
                for pi, batch in enumerate((b1, b2)):
                    codes, lens = batch.packed()
                    handles.append(backend.map_mate_slabs_begin(
                        codes, lens, tables[pi], (pi == 1) != pbat, b,
                        max_mismatches, pattern,
                    ))
                slab_streams, fb_any = [], None
                for h in handles:
                    s, fb = backend.map_mate_slabs_finish(h)
                    slab_streams.extend(s)
                    fb_any = fb if fb_any is None else (fb_any | fb)
            except Exception as e:
                if not is_oom_error(e):
                    raise
                # device HBM exhausted: route the whole batch to the exact
                # host path (byte-identical output) and keep going
                degraded_batches["pe"] += 1
                print(f"[waltx] device OOM, host-mapping batch of "
                      f"{len(b1)} pairs: {e}", file=sys.stderr)
                n_ = len(b1)
                C = getattr(backend, "cand_slab", 1)
                slab_streams = [
                    dict(seed=np.zeros((n_, C), dtype=np.int8),
                         pos=np.zeros((n_, C), dtype=np.uint32),
                         mm=np.zeros((n_, C), dtype=np.int32),
                         cnt=np.zeros(n_, dtype=np.int32))
                    for _ in range(4)
                ]
                fb_any = np.ones(n_, dtype=bool)
        return slab_streams, fb_any, lens_by_mate

    def emit_pair(b1, b2, mapped, i):
        """Finalize + host fallback + emission for mapped batch ``i``."""
        slab_streams, fb_any, lens_by_mate = mapped
        n0 = len(b1)
        stat.total_read_pairs += n0
        for pi, lens in enumerate(lens_by_mate):
            # short reads counted once per strand pass (paired.cpp:112-115);
            # accounted at emit time so a batch-granular checkpoint never
            # includes counts from a batch it has not emitted
            mate_stat = stat.mate1 if pi == 0 else stat.mate2
            mate_stat.num_of_short += 2 * int(
                np.sum(lens < pattern.min_read_len)
            )
        with perf.stage("native_finalize", batch=i):
            fin = native.pe_finalize(
                slab_streams, fb_any.astype(np.uint8),
                lens_by_mate[0].astype(np.int32),
                lens_by_mate[1].astype(np.int32),
                genome_meta.start_index.astype(np.uint32),
                top_k, frag_range, max_mismatches, pattern.exit1_seed,
            )
        fb_idx = np.flatnonzero(fb_any)
        perf.count("driver.pairs", n0)
        perf.count("driver.pairs_host", int(fb_idx.size))
        from walt_tpu_torch.core import refmap
        from walt_tpu_torch.host import replay as _replay

        codes1, _ = b1.packed()
        codes2, _ = b2.packed()

        def replay_fb(j):
            # exact host path for pairs whose streams were truncated
            rk = []
            for pi, codes_ in ((0, codes1), (1, codes2)):
                rk.append(replay_paired_topk(
                    [
                        (strand, refmap.enumerate_candidates(
                            codes_[j, : int(lens_by_mate[pi][j])],
                            g, ht, (pi == 1) != pbat, b,
                            max_mismatches, pattern))
                        for (g, ht), strand in zip(tables[pi], strands)
                    ],
                    max_mismatches, top_k, pattern,
                ))
            return rk

        fb_ranked = {}
        if fb_idx.size:
            with perf.stage("host_fallback", batch=i):
                per_mate = []
                for pi, codes_ in ((0, codes1), (1, codes2)):
                    got = native.pe_exact_ranked(
                        codes_[fb_idx], lens_by_mate[pi][fb_idx],
                        tables[pi], (pi == 1) != pbat, b, max_mismatches,
                        top_k, pattern,
                    )
                    per_mate.append(got)
                if all(g is not None for g in per_mate):
                    # join the exact ranked lists natively and scatter the
                    # verdicts into the batch arrays: fallback pairs then
                    # ride the same batched emission as everyone else
                    sub = native.pe_join_ranked(
                        per_mate[0], per_mate[1],
                        lens_by_mate[0][fb_idx], lens_by_mate[1][fb_idx],
                        genome_meta.start_index.astype(np.uint32),
                        frag_range, max_mismatches, top_k,
                    )
                    for kk in ("code", "frag", "r1_mm", "r1_pos", "r1_strand",
                               "r2_mm", "r2_pos", "r2_strand"):
                        fin[kk][fb_idx] = sub[kk]
                    for kk in ("bm_pos", "bm_times", "bm_strand", "bm_mm"):
                        fin[kk].reshape(-1, 2)[fb_idx] = (
                            sub[kk].reshape(-1, 2)
                        )
                else:
                    fb_ranked = dict(
                        zip(fb_idx, _replay.host_map(replay_fb, fb_idx))
                    )
        emitted = False
        if not fb_ranked:
            with perf.stage("host_emit", batch=i):
                emitted = emit_paired.write_pair_batch(
                    genome_meta, fin, b1, b2, lens_by_mate[0],
                    lens_by_mate[1], frag_range, stat, fouts, pbat, sam=sam,
                )
        if not emitted:
            with perf.stage("host_emit", batch=i):
                for j in range(n0):
                    if fb_any[j] and fb_ranked:
                        rk = fb_ranked[j]
                        merge_pair(
                            genome_meta, rk[0], rk[1], b1.names[j],
                            b1.seqs[j], b1.quals[j], b2.seqs[j],
                            b2.quals[j], frag_range, max_mismatches, sam,
                            stat, fouts, pattern, pbat=pbat,
                        )
                    else:
                        _emit_pair_finalized(
                            genome_meta, j, fin, b1.names[j], b1.seqs[j],
                            b1.quals[j], b2.seqs[j], b2.quals[j],
                            frag_range, max_mismatches, sam, stat, fouts,
                            pbat=pbat,
                        )

    if use_native:
        # Software-pipelined driver, like core/single_end.py: one mapper
        # thread keeps the device busy on batch i while the main thread
        # parses batch i+1 and finalizes/falls back/emits batch i-1.
        from concurrent.futures import ThreadPoolExecutor

        # Batch i's spans carry i on both threads; map_wait is the main
        # thread blocked on the mapper.
        def finish(pb1, pb2, pfut, i):
            nonlocal pairs_done
            with perf.stage("map_wait", batch=i):
                mapped = pfut.result()
            emit_pair(pb1, pb2, mapped, i)
            pairs_done += len(pb1)
            if ckpt is not None:
                ckpt.save(stat, files, pairs_done)

        with ThreadPoolExecutor(1) as ex, perf.profiler_trace():
            prev = None
            for i in itertools.count():
                b1, b2 = parse_pair(i)
                n = len(b1)
                fut = ex.submit(map_pair, b1, b2, i) if n else None
                if prev is not None:
                    finish(*prev)
                prev = (b1, b2, fut, i) if n else None
                if n < batch_size:
                    break
            if prev is not None:
                finish(*prev)
    else:
        while True:
            b1, b2 = parse_pair()
            n0 = len(b1)
            if n0 == 0:
                break
            ranked = [None, None]
            for pi, batch in enumerate((b1, b2)):
                ag_wildcard = (pi == 1) != pbat
                mate_stat = stat.mate1 if pi == 0 else stat.mate2
                codes, lens = batch.packed()
                streams = []
                for (g, ht), strand in zip(tables[pi], strands):
                    mate_stat.num_of_short += int(
                        np.sum(lens < pattern.min_read_len)
                    )
                    try:
                        per_read = backend.map_strand(
                            codes, lens, g, ht, ag_wildcard, b,
                            max_mismatches, pattern,
                        )
                    except Exception as e:
                        from walt_tpu_torch.core.errors import is_oom_error

                        if not is_oom_error(e):
                            raise
                        # device HBM exhausted: enumerate this strand on
                        # the exact host path (byte-identical) and go on
                        print(f"[waltx] device OOM, host-enumerating "
                              f"{len(batch)} reads: {e}", file=sys.stderr)
                        from walt_tpu_torch.core import refmap

                        seq_padded = refmap.padded_seq(g, pattern)
                        per_read = [
                            list(refmap.enumerate_candidates(
                                codes[j, : int(lens[j])], g, ht,
                                ag_wildcard, b, max_mismatches, pattern,
                                seq_padded=seq_padded,
                            ))
                            if int(lens[j]) >= pattern.min_read_len else []
                            for j in range(len(batch))
                        ]
                    streams.append((strand, per_read))
                ranked[pi] = [
                    replay_paired_topk(
                        [(strand, pr[j]) for strand, pr in streams],
                        max_mismatches, top_k, pattern,
                    )
                    for j in range(len(batch))
                ]
            stat.total_read_pairs += n0
            for j in range(n0):
                merge_pair(
                    genome_meta, ranked[0][j], ranked[1][j], b1.names[j],
                    b1.seqs[j], b1.quals[j], b2.seqs[j], b2.quals[j],
                    frag_range, max_mismatches, sam, stat, fouts, pattern,
                    pbat=pbat,
                )
            pairs_done += n0
            if ckpt is not None:
                ckpt.save(stat, files, pairs_done)
            if n0 < batch_size:
                break
    for ln in lines:
        ln.close()
    fout.close()
    for key in ("amb1", "unm1", "amb2", "unm2"):
        if fouts[key] is not None:
            fouts[key].close()

    with open(output_file + ".mapstats", "a") as ms:
        ms.write(stat.tostring(pattern.min_read_len) + "\n")
    if ckpt is not None:
        ckpt.save(stat, {}, pairs_done, done=True)
    if perf.enabled():
        perf.report(f"waltx perf PE {reads_file_1}")
    if verbose:
        print(f"mapping_time: {time.process_time() - t0}", file=sys.stderr)
    return stat
