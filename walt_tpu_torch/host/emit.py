"""Byte-exact MR / SAM / .mapstats emission.

Formats mirror the reference emitters line for line:
MR (mapping.cpp:347-356), single SAM (mapping.cpp:382-419), paired fragment
MR (paired.cpp:210-294), paired SAM (paired.cpp:333-435), mapstats
(mapping.cpp:47-63, paired.cpp:52-77), SAM header (reference.cpp:430-440).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from walt_tpu_torch.constants import WALT_VERSION
from walt_tpu_torch.genome import Genome
from walt_tpu_torch.host.replay import BestMatch

_COMPLEMENT = bytes.maketrans(b"ACGTacgtN", b"TGCAtgcaN")


def revcomp(seq: bytes) -> bytes:
    return seq.translate(_COMPLEMENT)[::-1]


def fmt_double(x: float) -> str:
    """std::ostream << double (default 6 significant digits).

    0/0 comes out of x86 SSE as the default quiet NaN with the sign bit set,
    which glibc prints as '-nan'.
    """
    if math.isnan(x):
        return "-nan"
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    return f"{x:g}"


def pct(a: float, b: float) -> float:
    if b == 0:
        return float("nan") if a == 0 else float("inf")
    return 100.0 * a / b


@dataclasses.dataclass
class StatSingleReads:
    """mapping.hpp:55-108."""

    total_reads: int = 0
    unique: int = 0
    ambiguous: int = 0
    unmapped: int = 0
    num_of_short: int = 0

    def update(self, times: int) -> None:
        """StatInfoUpdate (mapping.cpp:318-327)."""
        self.total_reads += 1
        if times == 0:
            self.unmapped += 1
        elif times == 1:
            self.unique += 1
        else:
            self.ambiguous += 1

    def tostring(self, min_read_len: int, n_tabs: int = 0) -> str:
        t = "    " * n_tabs
        return (
            f"{t}total_reads: {self.total_reads}\n"
            f"{t}mapped:\n"
            f"{t}    unique: {self.unique}\n"
            f"{t}    percent_unique: {fmt_double(pct(self.unique, self.total_reads))}\n"
            f"{t}    ambiguous: {self.ambiguous}\n"
            f"{t}unmapped: {self.unmapped}\n"
            f"{t}min_read_length: {min_read_len}\n"
            f"{t}too_short: {self.num_of_short}"
        )


@dataclasses.dataclass
class StatPairedReads:
    """paired.hpp:78-106."""

    total_read_pairs: int = 0
    unique_pairs: int = 0
    ambiguous_pairs: int = 0
    unmapped_pairs: int = 0
    mate1: StatSingleReads = dataclasses.field(default_factory=StatSingleReads)
    mate2: StatSingleReads = dataclasses.field(default_factory=StatSingleReads)
    frag_len_count: np.ndarray = None  # (frag_range+1,)

    def tostring(self, min_read_len: int) -> str:
        out = (
            "pairs:\n"
            f"    total_read_pairs: {self.total_read_pairs}\n"
            "    mapped:\n"
            f"        unique: {self.unique_pairs}\n"
            f"        percent_unique: "
            f"{fmt_double(pct(self.unique_pairs, self.total_read_pairs))}\n"
            f"        ambiguous: {self.ambiguous_pairs}\n"
            f"    unmapped: {self.unmapped_pairs}\n"
            "mate1:\n"
            f"{self.mate1.tostring(min_read_len, 1)}\n"
            "mate2:\n"
            f"{self.mate2.tostring(min_read_len, 1)}\n"
        )
        total = 0.0
        lines = ["frag_len_distribution:"]
        for i, c in enumerate(self.frag_len_count):
            lines.append(f"    {i}: {c}")
            total += i * float(c)
        denom = float(np.sum(self.frag_len_count, dtype=np.float64))
        mean = total / denom if denom != 0 else _c_div(total, denom)
        lines.append(f"frag_len_mean: {fmt_double(mean)}")
        return out + "\n".join(lines)


def _c_div(a: float, b: float) -> float:
    if a == 0:
        return float("nan")
    return float("inf") if a > 0 else float("-inf")


def sam_head(genome: Genome, command: str = "walt") -> str:
    """SAMHead (reference.cpp:430-440)."""
    out = ["@HD\tVN:1.0"]
    for name, ln in zip(genome.names, genome.lengths):
        out.append(f"@SQ\tSN:{name}\tLN:{ln}")
    out.append(f"@PG\tID:WALT\tVN:{WALT_VERSION}\tCL:{command}")
    return "\n".join(out) + "\n"


def _chrom_start(genome: Genome, bm: BestMatch, read_len: int):
    """Map a table position to (chr_id, forward-strand start).

    mapping.cpp:335-339: '-' strand entries index the per-chromosome reverse
    complement, so start = chrom_len - pos - read_len.
    """
    chr_id = int(genome.chrom_id_of(bm.genome_pos))
    start = bm.genome_pos - int(genome.start_index[chr_id])
    if bm.strand == "-":
        start = int(genome.lengths[chr_id]) - start - read_len
    return chr_id, start


def mr_line(bm: BestMatch, name: str, seq: bytes, qual: bytes, genome: Genome,
            ag_wildcard: bool) -> str:
    """OutputUniquelyAndAmbiguousMapped (mapping.cpp:329-350)."""
    chr_id, start = _chrom_start(genome, bm, len(seq))
    strand = bm.strand
    if ag_wildcard:
        strand = "-" if bm.strand == "+" else "+"
    return (
        f"{genome.names[chr_id]}\t{start}\t{start + len(seq)}\t{name}\t"
        f"{bm.mismatch}\t{strand}\t{seq.decode()}\t{qual.decode()}\n"
    )


def mr_unmapped_line(name: str, seq: bytes, qual: bytes) -> str:
    """OutputUnmapped (mapping.cpp:352-356)."""
    return f"{name}\t{seq.decode()}\t{qual.decode()}\n"


def single_mr(bm: BestMatch, name: str, seq: bytes, qual: bytes, genome: Genome,
              ag_wildcard: bool, out, out_ambiguous, out_unmapped) -> None:
    """OutputSingleResults (mapping.cpp:358-380).

    ``out_*`` are file-like or None (mirrors the ambiguous/unmapped flags).
    """
    if ag_wildcard:
        seq = revcomp(seq)
        qual = qual[::-1]
    if bm.times == 0 and out_unmapped is not None:
        out_unmapped.write(mr_unmapped_line(name, seq, qual))
    elif bm.times == 1:
        out.write(mr_line(bm, name, seq, qual, genome, ag_wildcard))
    elif bm.times >= 2 and out_ambiguous is not None:
        out_ambiguous.write(mr_line(bm, name, seq, qual, genome, ag_wildcard))


def write_single_batch(pos, times, minus, mm, batch, genome: Genome,
                       ag_wildcard: bool, sam: bool, ambiguous: bool,
                       unmapped: bool, fout, famb, funm,
                       stat: StatSingleReads, min_read_len: int) -> None:
    """Vectorized batch emission for the device SE path.

    Byte-identical to calling single_mr/single_sam per read: the chromosome
    mapping (searchsorted) and coordinate flip run once over the whole batch
    instead of per read.  ``pos/times/minus/mm`` are the BestMatch arrays
    from the device fold (shorts and unmapped reads carry times == 0).
    Spans: ``host_emit.prep`` (the NumPy part) and ``host_emit.native``
    (formatting and write).
    """
    from walt_tpu_torch import perf

    with perf.stage("host_emit.prep"):
        n = pos.shape[0]
        rlens = batch.lengths().astype(np.int64)
        start_index = genome.start_index.astype(np.int64)
        chr_id = np.searchsorted(start_index, pos.astype(np.int64),
                                 side="right") - 1
        start = pos.astype(np.int64) - start_index[chr_id]
        start = np.where(
            minus, genome.lengths.astype(np.int64)[chr_id] - start - rlens,
            start
        )
        short = rlens < min_read_len

        stat.total_reads += n
        stat.unmapped += int((times == 0).sum())
        stat.unique += int((times == 1).sum())
        stat.ambiguous += int((times >= 2).sum())
        stat.num_of_short += 2 * int(short.sum())
        if batch.native is not None:
            buf, noff, nlen, qoff, qlen, seqbytes = batch.native
            cnames = [s.encode() for s in genome.names]
            lens32 = np.asarray([len(s) for s in cnames], dtype=np.int32)
            offs = np.zeros(len(cnames), dtype=np.int64)
            if len(cnames) > 1:
                np.cumsum(lens32[:-1], out=offs[1:])
            blob_a = np.frombuffer(b"".join(cnames), dtype=np.uint8)
            rows = (buf, noff, nlen, qoff, qlen, seqbytes,
                    np.ascontiguousarray(batch.lengths(), dtype=np.int32),
                    np.ascontiguousarray(times, dtype=np.int32),
                    np.ascontiguousarray(minus).view(np.uint8),
                    np.ascontiguousarray(start, dtype=np.int64),
                    np.ascontiguousarray(mm, dtype=np.int32),
                    np.ascontiguousarray(chr_id, dtype=np.int32),
                    blob_a, offs, lens32)
            for f in (fout, famb, funm):
                if f is not None:
                    f.flush()

    if batch.native is not None:
        from walt_tpu_torch import native

        with perf.stage("host_emit.native"):
            if sam:
                ok = native.sam_emit(fout.fileno(), *rows, ambiguous,
                                     unmapped)
            else:
                ok = native.mr_emit(
                    fout.fileno(),
                    famb.fileno() if famb is not None else -1,
                    funm.fileno() if funm is not None else -1,
                    *rows, ag_wildcard,
                )
        if ok:
            return

    names = batch.names
    seqs = batch.seqs
    quals = batch.quals
    times_l = times.tolist()
    minus_l = minus.tolist()
    mm_l = mm.tolist()
    start_l = start.tolist()
    cname = [genome.names[c] for c in chr_id.tolist()]
    rl = rlens.tolist()

    main, amb, unm = [], [], []
    if not sam:
        for j in range(n):
            t = times_l[j]
            if t == 1 or (t >= 2 and famb is not None):
                seq, qual = seqs[j], quals[j]
                strand = "-" if minus_l[j] else "+"
                if ag_wildcard:
                    seq, qual = revcomp(seq), qual[::-1]
                    strand = "+" if minus_l[j] else "-"
                line = (
                    f"{cname[j]}\t{start_l[j]}\t{start_l[j] + rl[j]}\t"
                    f"{names[j]}\t{mm_l[j]}\t{strand}\t{seq.decode()}\t"
                    f"{qual.decode()}\n"
                )
                (main if t == 1 else amb).append(line)
            elif t == 0 and funm is not None:
                seq, qual = seqs[j], quals[j]
                if ag_wildcard:
                    seq, qual = revcomp(seq), qual[::-1]
                unm.append(f"{names[j]}\t{seq.decode()}\t{qual.decode()}\n")
        fout.writelines(main)
        if famb is not None:
            famb.writelines(amb)
        if funm is not None:
            funm.writelines(unm)
        return

    for j in range(n):
        t = times_l[j]
        neg = minus_l[j]
        flag = (0x4 if t == 0 else 0) | (0x10 if neg else 0) | (
            0x100 if t >= 2 else 0
        )
        if neg:
            seq_o, qual_o = revcomp(seqs[j]), quals[j][::-1]
        else:
            seq_o, qual_o = seqs[j], quals[j]
        if t == 0:
            if unmapped:
                main.append(
                    f"{names[j]}\t{flag}\t*\t0\t255\t*\t*\t0\t0\t"
                    f"{seq_o.decode()}\t{qual_o.decode()}\tNM:i:0\n"
                )
        elif t == 1 or ambiguous:
            main.append(
                f"{names[j]}\t{flag}\t{cname[j]}\t{start_l[j] + 1}\t255\t"
                f"{rl[j]}M\t*\t0\t0\t{seq_o.decode()}\t{qual_o.decode()}\t"
                f"NM:i:{mm_l[j]}\n"
            )
    fout.writelines(main)


def single_sam(bm: BestMatch, name: str, seq: bytes, qual: bytes, genome: Genome,
               ambiguous: bool, unmapped: bool, out) -> None:
    """OutputSingleSAM (mapping.cpp:382-419)."""
    flag = (0x4 if bm.times == 0 else 0) | (0x10 if bm.strand == "-" else 0) | (
        0x100 if bm.times >= 2 else 0
    )
    if bm.strand == "-":
        seq_o, qual_o = revcomp(seq), qual[::-1]
    else:
        seq_o, qual_o = seq, qual
    if bm.times == 0:
        if unmapped:
            out.write(
                f"{name}\t{flag}\t*\t0\t255\t*\t*\t0\t0\t"
                f"{seq_o.decode()}\t{qual_o.decode()}\tNM:i:0\n"
            )
        return
    if bm.times == 1 or (bm.times >= 2 and ambiguous):
        chr_id, start = _chrom_start(genome, bm, len(seq))
        out.write(
            f"{name}\t{flag}\t{genome.names[chr_id]}\t{start + 1}\t255\t"
            f"{len(seq)}M\t*\t0\t0\t{seq_o.decode()}\t{qual_o.decode()}\t"
            f"NM:i:{bm.mismatch}\n"
        )
