"""Device-resident index: packed lookup keys over the CSR hash table.

Port of ``walt_tpu/ops/device_index.py``.  The host preparation
(:class:`DeviceTable`, :func:`pack_key_words`, :func:`build_device_table`,
:func:`build_uniq_host`) is the JAX package's NumPy code, copied;
:func:`place_table`
turns a prepared table into resident tensors, and the device builders of
the accelerating structures (uniq run index, key16 prefixes, packed key
words) are torch.

Why these structures exist (see the JAX module for the full story): the
reference refines a hash bucket by binary-searching one cared position at a
time (mapping.cpp:166-222).  The device pipeline instead searches packed
2-bit keys of the cared positions 12..59, and buckets whose stored order is
not monotone under that model (chromosome-boundary sort quirks,
reference.cpp:258-288) are flagged for the exact host path.

Resident tensors follow the carrier convention of ``ops/packing``: int32
holding u32 bit patterns (int16 for key16 prefixes, uint8 for flags).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from walt_tpu_torch.constants import SeedPattern
from walt_tpu_torch.genome import Genome
from walt_tpu_torch.index.build import HashTable
from walt_tpu_torch.ops import packing

#: positions per packed 32-bit key word (2 bits per base)
POS_PER_WORD = 16
N_KEY_WORDS = 3  # cared positions 12..59
#: entries per pass of the device key builders (bounds their temporaries)
BUILD_CHUNK = 1 << 22
#: entries per pass of the uniq build: its temporaries (the int64 gather
#: windows and key values of one chunk, ~190 bytes per entry at the peak)
#: grow with this, not with the table.  2M entries peak at 0.362 GiB above
#: the table and the outputs, under a 0.5 GiB limit, and build a
#: 128M-entry table in 0.21-0.23 s against 0.26 s at 1M (one H100 80GB
#: HBM3, 700 W; tools/uniq_build_time.py)
UNIQ_CHUNK = 1 << 21


@dataclasses.dataclass
class DeviceTable:
    """One converted-genome table, ready to be placed on device."""

    pseq: np.ndarray  # uint32 packed converted genome words (+ zero tail)
    counter: np.ndarray  # uint32 (4^12 + 1,)
    index: np.ndarray  # uint32 (n,)
    key_words: np.ndarray | None  # uint32 (n, 3) packed cared[12..59];
    # None when they are to be computed on device from pseq + index
    start_index: np.ndarray  # uint32 (n_chroms + 1,)
    bucket_flagged: np.ndarray  # uint8 bit mask (4^12,): 1=fast, 2=exact_b
    max_bucket_bits: int  # static: iterations for the binary search
    strand: str
    #: probe count for the run-space (uniq) search; 0 = not built
    uniq_bits: int = 0


def pack_key_words(seq_padded: np.ndarray, entries: np.ndarray,
                   pattern: SeedPattern,
                   n_words: int = None) -> np.ndarray:
    """Pack raw genome bases at cared[12..59] into (n, n_words) uint32 words.

    Word w holds cared positions 12+16w .. 27+16w, first position in the two
    most significant bits, so unsigned comparison of a masked word equals
    lexicographic comparison of the bases.
    """
    if n_words is None:
        n_words = N_KEY_WORDS
    n = entries.shape[0]
    words = np.zeros((n, n_words), dtype=np.uint32)
    kw = pattern.key_weight
    # chunked so the int64 gather temporaries stay ~4 GB no matter the
    # entry count
    step = 1 << 28
    for a in range(0, n, step):
        z = min(a + step, n)
        e64 = entries[a:z].astype(np.int64)
        posbuf = np.empty(z - a, dtype=np.int64)
        val = np.empty(z - a, dtype=np.uint8)
        for w in range(n_words):
            acc = np.zeros(z - a, dtype=np.uint32)
            for i in range(POS_PER_WORD):
                p = kw + w * POS_PER_WORD + i
                if p >= pattern.cared_size:
                    acc <<= np.uint32(2)
                    continue
                off = int(pattern.cared[p])
                acc <<= np.uint32(2)
                np.add(e64, off, out=posbuf)
                np.take(seq_padded, posbuf, out=val)
                # & 3: past-the-genome pad bytes only occur in flagged
                # buckets (whose keys are never used)
                np.bitwise_and(val, 3, out=val)
                acc |= val
            words[a:z, w] = acc
    return words


def build_device_table(genome: Genome, table: HashTable,
                       pattern: SeedPattern,
                       with_key_words: bool = False) -> DeviceTable:
    """Prepare one table for the device pipeline (host-side, NumPy).

    ``with_key_words``: build the packed lookup keys on host (True: all 3
    words; "word0": the first only).  The default leaves them to the device
    builders below.
    """
    from walt_tpu_torch.core.refmap import padded_seq
    from walt_tpu_torch.index.build import seed_keys

    # Entries whose deep cared positions run past their chromosome were
    # sorted with the boundary-aware comparator (reference.cpp:258-288), so
    # the bucket's raw-byte order MAY differ from its stored order.  Only
    # buckets that contain a boundary entry AND are actually non-monotone
    # take the exact host path; their buckets are found by hashing the
    # boundary positions directly.
    last = int(pattern.cared[-1])
    starts = genome.start_index.astype(np.int64)
    seq_pad = padded_seq(genome, pattern)

    def _boundary_positions(tail_from_end: int):
        parts = []
        for c in range(genome.n_chroms):
            a, e = int(starts[c]), int(starts[c + 1])
            if e - a < pattern.min_seed_len:
                continue
            lo = max(a, e - tail_from_end)
            hi = e - pattern.min_seed_len
            if hi > lo:
                parts.append(np.arange(lo, hi, dtype=np.int64))
        return (np.concatenate(parts) if parts
                else np.zeros(0, dtype=np.int64))

    def _buckets_of(positions: np.ndarray) -> np.ndarray:
        if positions.size == 0:
            return positions
        keys = np.unique(seed_keys(seq_pad, positions, pattern))
        has = table.counter[keys + 1] > table.counter[keys]
        return keys[has]

    # Two flag tiers, packed as bits (the pipeline selects by ``exact_b``):
    #  bit0 (fast path): buckets whose stored order is non-monotone under
    #    the packed-key model or the host oracle's pad model;
    #  bit1 (exact path): bit0 plus every bucket holding a global-end entry,
    #    because there the refined COUNT itself feeds the -b cap.
    flagged = np.zeros(pattern.n_buckets, dtype=np.uint8)
    chrom_tail = _boundary_positions(last)
    glob_tail = chrom_tail[chrom_tail >= genome.length_of_genome - last]
    flagged[_buckets_of(glob_tail)] |= 2
    if chrom_tail.size:
        seq = seq_pad
        kw = pattern.key_weight
        deep = [int(pattern.cared[p])
                for p in range(kw, min(pattern.cared_size,
                                       kw + POS_PER_WORD * N_KEY_WORDS))]
        for bid in _buckets_of(chrom_tail):
            lo, hi = int(table.counter[bid]), int(table.counter[bid + 1])
            if hi - lo <= 1:
                continue
            kwds = pack_key_words(seq, table.index[lo:hi], pattern)
            a, b = kwds[:-1], kwds[1:]
            desc = (
                (a[:, 0] > b[:, 0])
                | ((a[:, 0] == b[:, 0]) & (a[:, 1] > b[:, 1]))
                | ((a[:, 0] == b[:, 0]) & (a[:, 1] == b[:, 1])
                   & (a[:, 2] > b[:, 2]))
            )
            if not desc.any():
                # the &3-packed model is monotone; also require the oracle's
                # raw-byte model (pad sorts above every base) to agree
                ent = table.index[lo:hi].astype(np.int64)
                raw = seq[ent[:, None] + np.asarray(deep)[None, :]]
                desc = (raw[:-1] > raw[1:]).astype(np.int8) - (
                    raw[:-1] < raw[1:]
                ).astype(np.int8)
                first = np.argmax(desc != 0, axis=1)
                desc = desc[np.arange(desc.shape[0]), first] > 0
            if desc.any():
                flagged[bid] |= 1 | 2

    sizes = np.diff(table.counter.astype(np.int64))
    max_bucket = int(sizes.max()) if sizes.size else 1
    key_words = None
    if with_key_words:
        key_words = pack_key_words(
            seq_pad, table.index, pattern,
            n_words=(1 if with_key_words == "word0" else N_KEY_WORDS),
        )
    return DeviceTable(
        # the tail covers a full max-length window (MAX_LINE_LENGTH 1000bp
        # -> 63 words) so the clamped window gather never shifts a near-end
        # window's start
        pseq=packing.pack_genome_np(genome.seq, tail_words=66),
        counter=table.counter,
        index=table.index,
        key_words=key_words,
        start_index=genome.start_index,
        bucket_flagged=flagged,
        max_bucket_bits=max(1, int(np.ceil(np.log2(max_bucket + 1)))),
        strand=genome.strand,
    )


def place_table(dt: DeviceTable, device) -> dict:
    """The resident tensors of a prepared table on ``device``.

    u32 arrays become int32 tensors with the same bits; ``bucket_flagged``
    stays uint8.  ``key_words`` is placed only when the host built it.
    """
    dev = dict(
        pseq=packing.from_np(dt.pseq, device),
        counter=packing.from_np(dt.counter, device),
        index=packing.from_np(dt.index, device),
        start_index=packing.from_np(dt.start_index, device),
        bucket_flagged=torch.from_numpy(
            np.ascontiguousarray(dt.bucket_flagged)).to(device),
    )
    if dt.key_words is not None:
        dev["key_words"] = packing.from_np(dt.key_words, device)
    return dev


def build_uniq_host(word0: np.ndarray, counter: np.ndarray):
    """Dedup word-0 runs within buckets (host NumPy; see build_uniq_device).

    ``word0``: (n,) uint32 first packed lookup key word per entry (stored
    bucket order); ``counter``: (nb + 1,) uint32 CSR offsets.  Returns
    (uniq_words (U,) u32, uniq_off (U + 1,) u32, uniq_counter (nb + 1,) u32,
    uniq_bits int).
    """
    n = int(word0.shape[0])
    breaks = np.zeros(n, dtype=bool)
    if n:
        breaks[0] = True
        breaks[1:] |= word0[1:] != word0[:-1]
        # a bucket boundary always starts a new run, even on equal words
        c = counter[(counter > 0) & (counter < n)]
        breaks[c.astype(np.int64)] = True
    starts = np.flatnonzero(breaks).astype(np.uint32)
    uniq_words = word0[starts.astype(np.int64)]
    uniq_off = np.append(starts, np.uint32(n)).astype(np.uint32)
    uniq_counter = np.searchsorted(starts, counter).astype(np.uint32)
    mx = int(np.diff(uniq_counter.astype(np.int64)).max()) if n else 0
    return (uniq_words, uniq_off, uniq_counter,
            max(1, int(np.ceil(np.log2(mx + 1)))))


def _cared_keys(pseq, index, offs, n_vals: int, a: int, z: int):
    """Packed 2-bit codes of the genome at ``entry + offs[i]``, i < n_vals,
    first value most significant, for entries [a, z) of ``index``; values
    past ``len(offs)`` pack as 0.  Returns (z - a,) int64.

    The window starts at the first cared offset, and all values come out of
    it in one gather (a handful of launches per chunk, not four per value):
    each base's bits come from the genome word holding it either way, end
    clamp included."""
    ent = packing.u32(index[a:z])
    offs = offs[:n_vals]
    if not offs:
        return torch.zeros_like(ent)
    dev, lo = ent.device, min(offs)
    rel = torch.tensor(offs, dtype=torch.int64, device=dev) - lo
    win = packing.window_words(pseq, ent + lo, ((max(offs) - lo) >> 4) + 1)
    vals = win[:, rel >> 4]
    vals >>= 30 - 2 * (rel & 15)
    vals &= 3
    vals <<= 2 * (n_vals - 1 - torch.arange(len(offs), device=dev))
    return vals.sum(1)  # the values' bits are disjoint: the sum is their OR


def _cared_offsets(pattern: SeedPattern, n_pos: int):
    kw = pattern.key_weight
    return [int(pattern.cared[p])
            for p in range(kw, min(pattern.cared_size, kw + n_pos))]


def build_uniq_device(pseq, index, counter, pattern: SeedPattern,
                      max_bytes: int | None = None,
                      chunk: int = UNIQ_CHUNK):
    """Dedup word-0 runs within buckets, computed from resident tensors.

    Entries within a bucket are stored sorted by their cared positions, so
    equal word-0 lookup keys form contiguous runs; the pipeline's uniq path
    binary-searches RUNS instead of entries.  Two passes over chunks of
    ``chunk`` entries, so the temporaries grow with the chunk and not with
    the table (the JAX builder's chunked fill, for the same reason): each
    chunk's word 0 per entry and run breaks (a word change from the entry
    before it, the previous chunk's last word carried, or a bucket start).
    The first pass counts the runs; the second fills the exact-size outputs:
    each run's word and first entry, and per bucket the runs before its
    first entry (the break count in front of it).

    Returns (uniq_words (U,) int32, uniq_off (U + 1,) int32,
    uniq_counter (nb + 1,) int32, uniq_bits int), exact-size, or None when
    the run arrays (8(U + 1) bytes) would exceed ``max_bytes``.
    """
    dev = index.device
    n = int(index.shape[0])
    nb1 = int(counter.shape[0])
    if n == 0:
        z = torch.zeros
        return (z(0, dtype=torch.int32, device=dev),
                z(1, dtype=torch.int32, device=dev),
                z(nb1, dtype=torch.int32, device=dev), 1)
    offs = _cared_offsets(pattern, POS_PER_WORD)
    bounds = list(range(0, n, chunk)) + [n]
    # counter is sorted and its values are <= n < 2^31: chunk c's bucket
    # starts are counter[edges[c]:edges[c + 1]]
    edges = torch.searchsorted(counter, torch.tensor(
        bounds, dtype=counter.dtype, device=dev)).tolist()

    def chunk_runs(c: int, prev):
        """(word 0, run breaks) of chunk c; ``prev``: the (1,) word 0 of the
        entry before it, None for the first chunk."""
        a, z = bounds[c], bounds[c + 1]
        w0 = packing.to_i32(_cared_keys(pseq, index, offs, POS_PER_WORD, a, z))
        brk = torch.empty(z - a, dtype=torch.bool, device=dev)
        if prev is None:
            brk[0] = True
        else:
            torch.ne(w0[:1], prev, out=brk[:1])
        torch.ne(w0[1:], w0[:-1], out=brk[1:])
        brk[(counter[edges[c]:edges[c + 1]] - a).long()] = True
        return w0, brk

    counts, prev = [], None
    for c in range(len(bounds) - 1):
        w0, brk = chunk_runs(c, prev)
        counts.append(brk.sum())
        prev = w0[-1:]
    counts = torch.stack(counts).tolist()
    U = sum(counts)
    if max_bytes is not None and 8 * (U + 1) > max_bytes:
        return None
    uniq_words = torch.empty(U, dtype=torch.int32, device=dev)
    uniq_off = torch.empty(U + 1, dtype=torch.int32, device=dev)
    uniq_counter = torch.empty(nb1, dtype=torch.int32, device=dev)
    uniq_off[U] = n
    uniq_counter[edges[-1]:] = U  # buckets that start at n: every run before
    off, prev = 0, None
    for c, k in enumerate(counts):
        a = bounds[c]
        w0, brk = chunk_runs(c, prev)
        prev = w0[-1:]
        st = torch.nonzero(brk).squeeze(1)
        uniq_words[off:off + k] = w0[st]
        uniq_off[off:off + k] = (st + a).to(torch.int32)
        cs = counter[edges[c]:edges[c + 1]]
        if cs.shape[0]:
            before = torch.cumsum(brk, 0, dtype=torch.int32) - brk.to(
                torch.int32)  # breaks in [a, a + i)
            uniq_counter[edges[c]:edges[c + 1]] = before[(cs - a).long()] + off
        off += k
    mx = int((uniq_counter[1:] - uniq_counter[:-1]).max())
    return (uniq_words, uniq_off, uniq_counter,
            max(1, int(np.ceil(np.log2(mx + 1)))))


def build_key16_device(pseq, index, pattern: SeedPattern,
                       chunk: int = BUILD_CHUNK):
    """(n,) int16: the top 16 bits (8 cared bases) of lookup key word 0.

    The lower-bound search only needs a sorted prefix to land at the start
    of the refined run GROUP; the remaining cared positions are checked
    from the verify window (the pipeline's window cared check).
    """
    n = int(index.shape[0])
    offs = _cared_offsets(pattern, 8)
    out = torch.empty(n, dtype=torch.int16, device=index.device)
    for a in range(0, n, chunk):
        z = min(a + chunk, n)
        acc = _cared_keys(pseq, index, offs, 8, a, z)
        out[a:z] = (acc - ((acc >> 15) << 16)).to(torch.int16)
    return out


def build_key_words_device(pseq, index, pattern: SeedPattern,
                           chunk: int = BUILD_CHUNK,
                           n_key_words: int = N_KEY_WORDS):
    """(n, n_key_words) int32 packed lookup keys, computed on device.

    The zero tail of the packed genome past its end equals the &3-masked pad
    of :func:`pack_key_words`.  The fast path (``exact_b`` off) probes word
    0 only, so its tables store one word.
    """
    n = int(index.shape[0])
    offs = _cared_offsets(pattern, POS_PER_WORD * n_key_words)
    out = torch.empty((n, n_key_words), dtype=torch.int32,
                      device=index.device)
    for a in range(0, n, chunk):
        z = min(a + chunk, n)
        for w in range(n_key_words):
            sub = offs[w * POS_PER_WORD:(w + 1) * POS_PER_WORD]
            out[a:z, w] = packing.to_i32(
                _cared_keys(pseq, index, sub, POS_PER_WORD, a, z))
    return out
