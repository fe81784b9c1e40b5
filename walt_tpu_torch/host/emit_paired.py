"""Paired-end output emission: fragment merge, paired SAM, mate fallback.

Byte-exact reimplementations of ``OutputBestPairedResults``
(paired.cpp:210-294), ``GetSAMFLAG`` (paired.cpp:80-95) and
``OutputPairedSAM`` (paired.cpp:333-435).
"""

from __future__ import annotations

from walt_tpu_torch.genome import Genome
from walt_tpu_torch.host.emit import revcomp
from walt_tpu_torch.host.replay import BestMatch


def forward_chrom_position(genome: Genome, genome_pos: int, strand: str,
                           chr_id: int, read_len: int):
    """ForwardChromPosition (paired.cpp:98-104)."""
    s = genome_pos - int(genome.start_index[chr_id])
    if strand != "+":
        s = int(genome.lengths[chr_id]) - s - read_len
    return s, s + read_len


def fragment_length(genome: Genome, r1, r2, len1: int, len2: int,
                    chr_id1: int, chr_id2: int) -> int:
    """GetFragmentLength (paired.cpp:320-331).  r = (mm, pos, strand)."""
    s1, e1 = forward_chrom_position(genome, r1[1], r1[2], chr_id1, len1)
    s2, e2 = forward_chrom_position(genome, r2[1], r2[2], chr_id2, len2)
    return (e2 - s1) if r1[2] == "+" else (e1 - s2)


def best_paired_mr(genome: Genome, r1, r2, frag_range: int, name: str,
                   seq1: bytes, qual1: bytes, seq2: bytes, qual2: bytes,
                   sam: bool, out):
    """OutputBestPairedResults (paired.cpp:210-294).  Returns fragment len."""
    len1, len2 = len(seq1), len(seq2)
    seq2_rev, qual2_rev = revcomp(seq2), qual2[::-1]
    chr_id1 = int(genome.chrom_id_of(r1[1]))
    s1, e1 = forward_chrom_position(genome, r1[1], r1[2], chr_id1, len1)
    chr_id2 = int(genome.chrom_id_of(r2[1]))
    s2, e2 = forward_chrom_position(genome, r2[1], r2[2], chr_id2, len2)

    overlap_s, overlap_e = max(s1, s2), min(e1, e2)
    plus = r1[2] == "+"
    one_l = s1 if plus else max(overlap_e, s1)
    one_r = min(overlap_s, e1) if plus else e1
    two_l = max(overlap_e, s2) if plus else s2
    two_r = e2 if plus else min(overlap_s, e2)
    frag_len = (two_r - one_l) if plus else (one_r - two_l)
    if sam:
        return frag_len

    seq = bytearray(b"N" * frag_len)
    qual = bytearray(b"B" * frag_len)
    if 0 < frag_len <= frag_range:
        lim_one = one_r - one_l
        seq[:lim_one] = seq1[:lim_one]
        qual[:lim_one] = qual1[:lim_one]
        lim_two = two_r - two_l
        if lim_two:
            seq[frag_len - lim_two :] = seq2_rev[len2 - lim_two :]
            qual[frag_len - lim_two :] = qual2_rev[len2 - lim_two :]
        if overlap_s < overlap_e:
            info_one = len1 - (seq1.count(b"N") + r1[0])
            info_two = len2 - (seq2_rev.count(b"N") + r2[0])
            if info_one >= info_two:
                a = (overlap_s - s1) if plus else (e1 - overlap_e)
                b = (overlap_e - s1) if plus else (e1 - overlap_s)
                seq[lim_one : lim_one + (b - a)] = seq1[a:b]
                qual[lim_one : lim_one + (b - a)] = qual1[a:b]
            else:
                a = (overlap_s - s2) if plus else (e2 - overlap_e)
                b = (overlap_e - s2) if plus else (e2 - overlap_s)
                seq[lim_one : lim_one + (b - a)] = seq2_rev[a:b]
                qual[lim_one : lim_one + (b - a)] = qual2_rev[a:b]

    start_pos = s1 if plus else s2
    out.write(
        f"{genome.names[chr_id1]}\t{start_pos}\t{start_pos + frag_len}\t"
        f"FRAG:{name}\t{r1[0] + r2[0]}\t{r1[2]}\t{seq.decode()}\t{qual.decode()}\n"
    )
    return frag_len


def write_pair_batch(genome: Genome, fin, b1, b2, lens1, lens2,
                     frag_range: int, stat, fouts, pbat: bool,
                     sam: bool = False) -> bool:
    """Vectorized + native batch emission for the device PE path.

    Byte-identical to driving :func:`best_paired_mr` / ``emit.single_mr``
    (MR mode) or :func:`paired_sam` (SAM mode) per pair from the finalizer's
    arrays: chromosome mapping and coordinate flips run once over the batch
    (NumPy), line splicing/formatting in walt_tpu_torch.native (fastio.cpp
    pe_emit_batch / pe_sam_emit_batch).  Returns False when the native batch
    data or library is unavailable (caller falls back to the per-pair loop).
    Spans: ``host_emit.prep`` (the NumPy part) and ``host_emit.native``
    (formatting and write).
    """
    from walt_tpu_torch import native, perf

    if b1.native is None or b2.native is None or native.get_lib() is None:
        return False
    with perf.stage("host_emit.prep"):
        call = _pair_batch_call(genome, fin, b1, b2, lens1, lens2,
                                frag_range, stat, fouts, pbat, sam)
    with perf.stage("host_emit.native"):
        return call()


def _pair_batch_call(genome: Genome, fin, b1, b2, lens1, lens2,
                     frag_range: int, stat, fouts, pbat: bool, sam: bool):
    """:func:`write_pair_batch`'s NumPy preparation: the stats and the
    arrays of the native emitter, whose call it returns."""
    import functools

    import numpy as np

    from walt_tpu_torch import native

    code = fin["code"]
    n = code.shape[0]
    start_index = genome.start_index.astype(np.int64)
    glens = genome.lengths.astype(np.int64)

    def fwd(pos, minus, ln):
        p = pos.astype(np.int64)
        chrid = np.searchsorted(start_index, p, side="right") - 1
        s = p - start_index[chrid]
        s = np.where(minus, glens[chrid] - s - ln, s)
        return np.ascontiguousarray(chrid.astype(np.int32)), s

    l1 = lens1.astype(np.int64)
    l2 = lens2.astype(np.int64)
    # unique pairs: forward-chrom spans of both mates (paired.cpp:98-104)
    chr1u, s1 = fwd(fin["r1_pos"], fin["r1_strand"] != 0, l1)
    chr2u, s2 = fwd(fin["r2_pos"], fin["r2_strand"] != 0, l2)
    plus = np.ascontiguousarray((fin["r1_strand"] == 0).view(np.uint8))
    # non-unique pairs: per-mate BestMatch display coordinates
    bmp = fin["bm_pos"].reshape(n, 2)
    bms = fin["bm_strand"].reshape(n, 2)
    bmt = fin["bm_times"].reshape(n, 2)
    bmm = fin["bm_mm"].reshape(n, 2)
    c1s, st1 = fwd(bmp[:, 0], bms[:, 0] != 0, l1)
    c2s, st2 = fwd(bmp[:, 1], bms[:, 1] != 0, l2)

    # --- stats, vectorized (identical to the per-pair updates) ---
    uniq = code == 0
    nu = ~uniq
    stat.unique_pairs += int(uniq.sum())
    stat.ambiguous_pairs += int((code == 1).sum())
    stat.unmapped_pairs += int((code == 2).sum())
    fr = fin["frag"][uniq]
    if fr.size:
        np.add.at(stat.frag_len_count, fr, 1)
    for mate_stat, tcol in ((stat.mate1, bmt[nu, 0]), (stat.mate2, bmt[nu, 1])):
        mate_stat.total_reads += int(tcol.size)
        mate_stat.unmapped += int((tcol == 0).sum())
        mate_stat.unique += int((tcol == 1).sum())
        mate_stat.ambiguous += int((tcol >= 2).sum())

    cnames = [s.encode() for s in genome.names]
    clen = np.asarray([len(s) for s in cnames], dtype=np.int32)
    coff = np.zeros(len(cnames), dtype=np.int64)
    if len(cnames) > 1:
        np.cumsum(clen[:-1], out=coff[1:])
    blob = np.frombuffer(b"".join(cnames), dtype=np.uint8)
    c = np.ascontiguousarray

    if sam:
        # display arrays merging unique hits (times := 1) and BestMatch rows
        # -- the per-pair _emit_pair_finalized SAM path, vectorized
        t1d = c(np.where(uniq, 1, bmt[:, 0]).astype(np.int32))
        t2d = c(np.where(uniq, 1, bmt[:, 1]).astype(np.int32))
        s1d = c(np.where(uniq, s1, st1))
        s2d = c(np.where(uniq, s2, st2))
        c1d = c(np.where(uniq, chr1u, c1s))
        c2d = c(np.where(uniq, chr2u, c2s))
        m1d = c(np.where(uniq, fin["r1_mm"], bmm[:, 0]).astype(np.int32))
        m2d = c(np.where(uniq, fin["r2_mm"], bmm[:, 1]).astype(np.int32))
        mi1 = c(np.where(uniq, fin["r1_strand"] != 0, bms[:, 0] != 0)
                ).view(np.uint8)
        mi2 = c(np.where(uniq, fin["r2_strand"] != 0, bms[:, 1] != 0)
                ).view(np.uint8)
        fragd = c(np.where(uniq, fin["frag"], 0).astype(np.int32))
        fouts["out"].flush()
        return functools.partial(
            native.pe_sam_emit, fouts["out"].fileno(), b1.native, b2.native,
            c(lens1, dtype=np.int32), c(lens2, dtype=np.int32),
            fin["code"], fragd,
            (t1d, s1d, c1d, m1d, mi1), (t2d, s2d, c2d, m2d, mi2),
            (blob, coff, clen),
            bool(fouts["ambiguous"]), bool(fouts["unmapped"]),
        )

    handles = [fouts["out"], fouts["amb1"], fouts["unm1"], fouts["amb2"],
               fouts["unm2"]]
    fds = []
    for h in handles:
        if h is None:
            fds.append(-1)
        else:
            h.flush()
            fds.append(h.fileno())

    return functools.partial(
        native.pe_emit, fds, b1.native, b2.native,
        c(lens1, dtype=np.int32), c(lens2, dtype=np.int32), fin,
        (chr1u, c(s1), c(s1 + l1), c(s2), c(s2 + l2), plus),
        ((c(bmt[:, 0]), c(st1), c1s, c(bmm[:, 0]),
          c(bms[:, 0]).view(np.uint8)),
         (c(bmt[:, 1]), c(st2), c2s, c(bmm[:, 1]),
          c(bms[:, 1]).view(np.uint8))),
        (blob, coff, clen), frag_range, pbat,
    )


def sam_flag(paired, paired_mapped, unmapped, next_unmapped, rev, next_rev,
             first, last, secondary) -> int:
    """GetSAMFLAG (paired.cpp:80-95)."""
    return (
        (0x1 if paired else 0)
        | (0x2 if paired_mapped else 0)
        | (0x4 if unmapped else 0)
        | (0x8 if next_unmapped else 0)
        | (0x10 if rev else 0)
        | (0x20 if next_rev else 0)
        | (0x40 if first else 0)
        | (0x80 if last else 0)
        | (0x100 if secondary else 0)
    )


def paired_sam(bm1: BestMatch, bm2: BestMatch, genome: Genome, name: str,
               seq1: bytes, qual1: bytes, seq2: bytes, qual2: bytes,
               frag_len: int, flag1: int, flag2: int,
               amb1: bool, unm1: bool, amb2: bool, unm2: bool, out) -> None:
    """OutputPairedSAM (paired.cpp:333-435)."""
    chr_id1 = int(genome.chrom_id_of(bm1.genome_pos))
    chr_id2 = int(genome.chrom_id_of(bm2.genome_pos))
    s1, _ = forward_chrom_position(genome, bm1.genome_pos, bm1.strand, chr_id1, len(seq1))
    s2, _ = forward_chrom_position(genome, bm2.genome_pos, bm2.strand, chr_id2, len(seq2))

    mismatch1, mismatch2 = bm1.mismatch, bm2.mismatch
    if bm1.times == 0:
        s1, mismatch1 = 0, 0
    else:
        s1 += 1
    if bm2.times == 0:
        s2, mismatch2 = 0, 0
    else:
        s2 += 1

    len1 = frag_len if bm1.strand == "+" else -frag_len
    len2 = frag_len if bm2.strand == "+" else -frag_len

    if flag1 & 0x2:
        rnext1 = rnext2 = "="
    else:
        rnext1 = "*" if bm1.times == 0 else genome.names[chr_id1]
        rnext2 = "*" if bm2.times == 0 else genome.names[chr_id2]

    so1, qo1 = (revcomp(seq1), qual1[::-1]) if bm1.strand == "-" else (seq1, qual1)
    so2, qo2 = (revcomp(seq2), qual2[::-1]) if bm2.strand == "-" else (seq2, qual2)

    def line(bm, flag, s_self, s_mate, rnext, chr_id, tlen, so, qo, mm, amb, unm):
        if bm.times == 0:
            if unm:
                out.write(
                    f"{name}\t{flag}\t*\t{s_self}\t255\t*\t{rnext}\t{s_mate}\t"
                    f"{tlen}\t{so.decode()}\t{qo.decode()}\tNM:i:{mm}\n"
                )
        elif bm.times == 1 or (bm.times >= 2 and amb):
            out.write(
                f"{name}\t{flag}\t{genome.names[chr_id]}\t{s_self}\t255\t"
                f"{len(so)}M\t{rnext}\t{s_mate}\t{tlen}\t{so.decode()}\t"
                f"{qo.decode()}\tNM:i:{mm}\n"
            )

    line(bm1, flag1, s1, s2, rnext2, chr_id1, len1, so1, qo1, mismatch1, amb1, unm1)
    line(bm2, flag2, s2, s1, rnext1, chr_id2, len2, so2, qo2, mismatch2, amb2, unm2)
