"""The plain reference: WALT's exact mapping of a sample of reads or pairs.

A frozen, self-contained copy of the exact host path (seed-pattern tables,
the bucket index, the binary-search refinement, the best-hit replay and the
paired-end top-k heap and pair join, the MR lines), in NumPy, with the index
part in plain PyTorch so that it can run on the card after the window.  It
imports nothing of the program, and builds its index from the genome the
benchmark made: only the buckets the sample's seeds hash to, each sorted by
WALT's comparator (reference.cpp:258-288), positions ascending within full
ties.

WALT sorts each bucket with ``std::sort``, whose order among full ties (two
positions equal on every cared base) this copy does not reproduce.  A
single-end answer does not depend on that order (a read is unique only when
every best hit is one position).  A paired-end mate's top-k heap does when
more than k of its candidates are at or below the heap's worst mismatch:
which of the tied ones it keeps then follows the order.  Such pairs are
marked ``order_dependent`` and their records are not judged.
"""

from __future__ import annotations

import dataclasses

import numpy as np

CODE_TO_BASE = np.frombuffer(b"ACGT", dtype=np.uint8).copy()
LOOKUP_PAD = np.uint8(200)
EXTREMAL_BUCKET = 500_000
KEY_WEIGHT = 12
_COMPLEMENT = bytes.maketrans(b"ACGTN", b"TGCAN")


# ---- seed patterns (seedpattern.hpp, as WALT ships them) -------------------
@dataclasses.dataclass(frozen=True)
class Pattern:
    name: str
    pattern_len: int
    cared_weight: int
    min_read_len: int
    min_seed_len: int
    cared: tuple
    verify_skip: tuple
    exit1_seed: int

    @property
    def key_span(self) -> int:
        return self.pattern_len + self.cared[KEY_WEIGHT - 1]

    def repeats(self, read_len: int) -> int:
        return min((read_len - self.pattern_len + 1) // self.pattern_len, 50)

    def seed_len(self, read_len: int) -> int:
        return min(self.repeats(read_len) * self.cared_weight,
                   len(self.cared))


def _cared(period, size):
    return tuple(p for p in range(8 * len(period) * size)
                 if period[p % len(period)] == 1)[:size]


PATTERNS = {
    "3": Pattern("3", 3, 1, 38, 36, _cared((0, 1, 0), 60),
                 ((2, 23, 70), (2, 47, 142)), 2),
    "5": Pattern("5", 5, 2, 32, 30, _cared((1, 0, 1, 0, 0), 56), (), 2),
    "7": Pattern("7", 7, 4, 23, 21, _cared((1, 1, 1, 0, 1, 0, 0), 80), (),
                 4),
}


# ---- converted genomes and their bucket index -----------------------------
def revcomp_genome(seq: np.ndarray, start_index: np.ndarray) -> np.ndarray:
    out = seq.copy()
    for i in range(start_index.shape[0] - 1):
        a, b = int(start_index[i]), int(start_index[i + 1])
        out[a:b] = 3 - seq[a:b][::-1]
    return out


def converted(seq, start_index, table: str) -> np.ndarray:
    """The genome of one of WALT's four tables (makedb.cpp:144-155)."""
    s = revcomp_genome(seq, start_index) if table.endswith("1") else seq
    if table.startswith("CT"):
        return np.where(s == 1, np.uint8(3), s)
    return np.where(s == 2, np.uint8(0), s)


def read_keys(conv_read: np.ndarray, pattern: Pattern) -> list:
    """The hash key of each seed shift of a converted read; a read shorter
    than the key span reads base code 0 past its end."""
    keyed = conv_read
    if keyed.shape[0] < pattern.key_span:
        keyed = np.zeros(pattern.key_span, dtype=np.uint8)
        keyed[:conv_read.shape[0]] = conv_read
    out = []
    for s in range(pattern.pattern_len):
        k = 0
        for i in range(KEY_WEIGHT):
            k = (k << 2) | int(keyed[s + pattern.cared[i]])
        out.append(k)
    return out


def bucket_index(conv: np.ndarray, start_index: np.ndarray, keys,
                 pattern: Pattern, device="cpu") -> dict:
    """key -> the bucket's positions in WALT's order, for ``keys`` only.

    Seeds start at every position of a sequence but its last
    ``min_seed_len`` (reference.cpp:199-207); a bucket of 500,000 entries or
    more is erased (reference.cpp:211-218).
    """
    import torch

    keys = sorted(set(int(k) for k in keys))
    if not keys:
        return {}
    pad = pattern.cared[-1] + 2
    seq_t = torch.from_numpy(np.concatenate(
        [conv, np.zeros(pad, dtype=np.uint8)])).to(device)
    want = torch.zeros(4 ** KEY_WEIGHT, dtype=torch.bool, device=device)
    want[torch.tensor(keys, dtype=torch.long, device=device)] = True
    picked_pos, picked_key = [], []
    step = 1 << 25
    for c in range(start_index.shape[0] - 1):
        a = int(start_index[c])
        z = int(start_index[c + 1]) - pattern.min_seed_len
        if int(start_index[c + 1]) - a < pattern.min_seed_len or z <= a:
            continue
        for lo in range(a, z, step):
            pos = torch.arange(lo, min(lo + step, z), dtype=torch.long,
                               device=device)
            key = torch.zeros_like(pos)
            for i in range(KEY_WEIGHT):
                key = (key << 2) | seq_t[pos + pattern.cared[i]].long()
            m = want[key]
            picked_pos.append(pos[m].cpu().numpy())
            picked_key.append(key[m].cpu().numpy())
    del seq_t, want
    pos = np.concatenate(picked_pos)
    key = np.concatenate(picked_key)
    counts = np.bincount(key, minlength=4 ** KEY_WEIGHT)
    keep = counts[key] < EXTREMAL_BUCKET
    pos, key = pos[keep], key[keep]
    cols = _comparator_columns(conv, start_index, pos, pattern)
    order = np.lexsort(list(reversed(cols)) + [key])
    pos, key = pos[order], key[order]
    cut = np.flatnonzero(np.diff(key)) + 1
    out = {int(k[0]): p.astype(np.int64)
           for k, p in zip(np.split(key, cut), np.split(pos, cut)) if k.size}
    return {k: out.get(k, np.zeros(0, dtype=np.int64)) for k in keys}


def _comparator_columns(conv, start_index, pos, pattern: Pattern) -> list:
    """Per cared position from the key on: base + 1, or 0 past the end of
    the entry's sequence, packed 3 bits each into uint64 words of 16."""
    idx = pos.astype(np.int64)
    chrom = np.searchsorted(start_index, idx, side="right") - 1
    remain = start_index.astype(np.int64)[chrom + 1] - idx
    ext = np.concatenate([conv, np.zeros(pattern.cared[-1] + 2,
                                         dtype=np.uint8)])
    cols = []
    size = len(pattern.cared)
    for a in range(KEY_WEIGHT, size, 16):
        z = min(a + 16, size)
        acc = np.zeros(idx.shape[0], dtype=np.uint64)
        for p in range(a, z):
            off = pattern.cared[p]
            val = ext[idx + off].astype(np.uint64) + np.uint64(1)
            val[off >= remain] = 0
            acc = (acc << np.uint64(3)) | val
        if z - a < 16:
            acc <<= np.uint64(3 * (16 - (z - a)))
        cols.append(acc)
    return cols


# ---- exact candidate enumeration (mapping.cpp:166-316) ----------------------
def convert_read(codes: np.ndarray, ag_wildcard: bool) -> np.ndarray:
    if ag_wildcard:
        return np.where(codes == 2, np.uint8(0), codes)
    return np.where(codes == 1, np.uint8(3), codes)


def _refine(read, seq, bucket, seed_len, pattern: Pattern):
    """IndexRegion + Lower/UpperBound over one sorted bucket: inclusive
    (l, u), or None."""
    l, u = 0, bucket.shape[0] - 1
    for p in range(KEY_WEIGHT, seed_len):
        cp = pattern.cared[p]
        c = read[cp]
        low, high = l, u
        while low < high:
            mid = low + (high - low) // 2
            if seq[int(bucket[mid]) + cp] >= c:
                high = mid
            else:
                low = mid + 1
        l = low
        low, high = l, u
        while low < high:
            mid = low + (high - low + 1) // 2
            if seq[int(bucket[mid]) + cp] <= c:
                low = mid
            else:
                high = mid - 1
        u = low
        if l == u and seq[int(bucket[l]) + cp] != c:
            return None
    if l > u:
        return None
    return l, u


def candidates(read_codes, table, ag_wildcard, b, max_mm,
               pattern: Pattern, shifts: int | None = None):
    """(seed, genome position, mismatches) of one read against one table,
    in WALT's order.  ``shifts`` (the control only) examines the first
    ``shifts`` seed shifts instead of all ``pattern_len``."""
    seq, start_index, buckets = table
    read_len = int(read_codes.shape[0])
    if read_len < pattern.min_read_len:
        return []
    read = convert_read(read_codes, ag_wildcard)
    keys = read_keys(read, pattern)
    keyed = read
    if read_len < pattern.key_span:
        keyed = np.zeros(pattern.key_span, dtype=np.uint8)
        keyed[:read_len] = read
    repeats = pattern.repeats(read_len)
    seed_len = pattern.seed_len(read_len)
    starts = start_index.astype(np.int64)
    out = []
    for seed_i in range(min(shifts or pattern.pattern_len,
                            pattern.pattern_len)):
        bucket = buckets[keys[seed_i]]
        if bucket.shape[0] == 0:
            continue
        region = _refine(keyed[seed_i:], seq, bucket, seed_len, pattern)
        if region is None:
            continue
        l, u = region
        if u - l + 1 > b:
            continue
        entries = bucket[l: u + 1]
        chrom = np.searchsorted(starts, entries, side="right") - 1
        ok = (entries - starts[chrom]) >= seed_i
        gpos = entries - seed_i
        ok &= (gpos + read_len) < starts[chrom + 1]
        win = seq[gpos[:, None] + np.arange(read_len)]
        mm = np.count_nonzero(win != read, axis=1).astype(np.int64)
        for shift, min_rep, p in pattern.verify_skip:
            if seed_i == shift and repeats >= min_rep:
                mm -= (win[:, p] != read[p]).astype(np.int64)
        ok &= mm <= max_mm
        out.extend((seed_i, int(gpos[j]), int(mm[j]))
                   for j in np.flatnonzero(ok))
    return out


def _seed_allowed(best_mm: int, seed_i: int, exit1_seed: int) -> bool:
    if best_mm == 0 and seed_i:
        return False
    return not (best_mm == 1 and seed_i >= exit1_seed)


def best_single(streams, max_mm: int, pattern: Pattern):
    """BestMatch replay (mapping.cpp:224-316): (pos, times, strand, mm)."""
    pos_, times, strand_, best = 0, 0, "+", max_mm
    for strand, cands in streams:
        prev, allowed = -1, True
        for seed_i, pos, mm in cands:
            if seed_i != prev:
                allowed = _seed_allowed(best, seed_i, pattern.exit1_seed)
                prev = seed_i
            if not allowed:
                continue
            if mm < best:
                pos_, times, strand_, best = pos, 1, strand, mm
            elif mm == best and pos_ != pos:
                pos_, strand_ = pos, strand
                times += 1
    return pos_, times, strand_, best


# ---- libstdc++ priority_queue, as paired.hpp's top-k heap uses it ---------
class _Heap:
    def __init__(self, k: int):
        self.v, self.k = [], k

    def _up(self, hole, top, value):
        v = self.v
        parent = (hole - 1) // 2
        while hole > top and v[parent][0] < value[0]:
            v[hole] = v[parent]
            hole = parent
            parent = (hole - 1) // 2
        v[hole] = value

    def _push(self, value):
        self.v.append(value)
        self._up(len(self.v) - 1, 0, value)

    def _pop(self):
        v = self.v
        result = v[0]
        if len(v) > 1:
            value = v[-1]
            v[-1] = v[0]
            length, hole = len(v) - 1, 0
            second = 0
            while second < (length - 1) // 2:
                second = 2 * (second + 1)
                if v[second][0] < v[second - 1][0]:
                    second -= 1
                v[hole] = v[second]
                hole = second
            if (length & 1) == 0 and second == (length - 2) // 2:
                second = 2 * (second + 1)
                v[hole] = v[second - 1]
                hole = second - 1
            self._up(hole, 0, value)
        v.pop()
        return result

    def full(self):
        return len(self.v) >= self.k

    def push(self, cand):
        if len(self.v) < self.k:
            self._push(cand)
        elif cand[0] < self.v[0][0]:
            self._pop()
            self._push(cand)

    def drain(self):
        out = []
        while self.v:
            out.append(self._pop())
        return out


def ranked_mate(streams, max_mm: int, top_k: int, pattern: Pattern):
    """One mate's top-k replay (paired.cpp:131-199) and heap drain: (ranked
    list of (mm, pos, strand), order_dependent)."""
    heap = _Heap(top_k)
    pushed = []
    for strand, cands in streams:
        prev, allowed = -1, True
        for seed_i, pos, mm in cands:
            if seed_i != prev:
                allowed = (not heap.v or not heap.full()
                           or _seed_allowed(heap.v[0][0], seed_i,
                                            pattern.exit1_seed))
                prev = seed_i
            if not allowed or mm > max_mm:
                continue
            pushed.append(mm)
            heap.push((mm, pos, strand))
    dependent = False
    if heap.full():
        worst = heap.v[0][0]
        dependent = sum(m <= worst for m in pushed) > top_k
    return heap.drain(), dependent


# ---- MR lines ---------------------------------------------------------------
def revcomp(seq: bytes) -> bytes:
    return seq.translate(_COMPLEMENT)[::-1]


class Meta:
    def __init__(self, names, lengths, start_index):
        self.names = list(names)
        self.lengths = np.asarray(lengths, dtype=np.int64)
        self.start_index = np.asarray(start_index, dtype=np.int64)

    def chrom(self, pos: int) -> int:
        return int(np.searchsorted(self.start_index, pos, side="right")) - 1


def mr_line(meta: Meta, pos, strand, mm, name, seq, qual, ag_wildcard):
    """OutputSingleResults for a uniquely mapped read (mapping.cpp:329-380)."""
    if ag_wildcard:
        seq, qual = revcomp(seq), qual[::-1]
        strand = "-" if strand == "+" else "+"
    c = meta.chrom(pos)
    start = pos - int(meta.start_index[c])
    if (strand == "-") != ag_wildcard:
        start = int(meta.lengths[c]) - start - len(seq)
    return (f"{meta.names[c]}\t{start}\t{start + len(seq)}\t{name}\t{mm}\t"
            f"{strand}\t{seq.decode()}\t{qual.decode()}\n").encode()


def _fwd(meta: Meta, r, read_len):
    c = meta.chrom(r[1])
    s = r[1] - int(meta.start_index[c])
    if r[2] != "+":
        s = int(meta.lengths[c]) - s - read_len
    return c, s, s + read_len


def frag_line(meta: Meta, r1, r2, frag_range, name, seq1, qual1, seq2,
              qual2):
    """OutputBestPairedResults (paired.cpp:210-294): (line, fragment)."""
    len1, len2 = len(seq1), len(seq2)
    seq2r, qual2r = revcomp(seq2), qual2[::-1]
    c1, s1, e1 = _fwd(meta, r1, len1)
    _, s2, e2 = _fwd(meta, r2, len2)
    ov_s, ov_e = max(s1, s2), min(e1, e2)
    plus = r1[2] == "+"
    one_l = s1 if plus else max(ov_e, s1)
    one_r = min(ov_s, e1) if plus else e1
    two_l = max(ov_e, s2) if plus else s2
    two_r = e2 if plus else min(ov_s, e2)
    frag = (two_r - one_l) if plus else (one_r - two_l)
    seq = bytearray(b"N" * frag)
    qual = bytearray(b"B" * frag)
    if 0 < frag <= frag_range:
        lim1 = one_r - one_l
        seq[:lim1], qual[:lim1] = seq1[:lim1], qual1[:lim1]
        lim2 = two_r - two_l
        if lim2:
            seq[frag - lim2:] = seq2r[len2 - lim2:]
            qual[frag - lim2:] = qual2r[len2 - lim2:]
        if ov_s < ov_e:
            info1 = len1 - (seq1.count(b"N") + r1[0])
            info2 = len2 - (seq2r.count(b"N") + r2[0])
            if info1 >= info2:
                a = (ov_s - s1) if plus else (e1 - ov_e)
                b = (ov_e - s1) if plus else (e1 - ov_s)
                seq[lim1: lim1 + b - a], qual[lim1: lim1 + b - a] = \
                    seq1[a:b], qual1[a:b]
            else:
                a = (ov_s - s2) if plus else (e2 - ov_e)
                b = (ov_e - s2) if plus else (e2 - ov_s)
                seq[lim1: lim1 + b - a], qual[lim1: lim1 + b - a] = \
                    seq2r[a:b], qual2r[a:b]
    start = s1 if plus else s2
    line = (f"{meta.names[c1]}\t{start}\t{start + frag}\tFRAG:{name}\t"
            f"{r1[0] + r2[0]}\t{r1[2]}\t{seq.decode()}\t{qual.decode()}\n")
    return line.encode(), frag


def _single_from_ranked(ranked, max_mm):
    """GetBestMatch4Single (paired.cpp:296-318)."""
    pos_, times, strand_, best = 0, 0, "+", max_mm
    for mm, pos, strand in reversed(ranked):
        if mm < best:
            pos_, times, strand_, best = pos, 1, strand, mm
        elif mm == best:
            if pos_ == pos:
                continue
            pos_, strand_ = pos, strand
            times += 1
        else:
            break
    return pos_, times, strand_, best


def pair_lines(meta: Meta, ranked1, ranked2, name, seq1, qual1, seq2,
               qual2, frag_range, max_mm):
    """MergePairedEndResults (paired.cpp:438-570), MR output: the lines a
    pair writes, and its class ("unique", "ambiguous", "unmapped")."""
    len1, len2 = len(seq1), len(seq2)
    best, min_mm, best_pos, best_times = (-1, -1), max_mm, 0, 0
    for i in range(len(ranked1) - 1, -1, -1):
        r1 = ranked1[i]
        c1 = meta.chrom(r1[1])
        for j in range(len(ranked2) - 1, -1, -1):
            r2 = ranked2[j]
            if r1[2] == r2[2]:
                continue
            mm = r1[0] + r2[0]
            if mm > min_mm:
                break
            if c1 != meta.chrom(r2[1]):
                continue
            _, s1, e1 = _fwd(meta, r1, len1)
            _, s2, e2 = _fwd(meta, r2, len2)
            frag = (e2 - s1) if r1[2] == "+" else (e1 - s2)
            if frag <= 0 or frag > frag_range:
                continue
            cur = (r1[1] << 32) + r2[1]
            if mm < min_mm:
                best, best_times, min_mm, best_pos = (i, j), 1, mm, cur
            elif mm == min_mm and cur != best_pos:
                best = (i, j)
                best_times += 1
    if best_times == 1:
        line, _ = frag_line(meta, ranked1[best[0]], ranked2[best[1]],
                            frag_range, name, seq1, qual1, seq2, qual2)
        return [line], "unique"
    lines = []
    for ranked, seq, qual, ag in ((ranked1, seq1, qual1, False),
                                  (ranked2, seq2, qual2, True)):
        pos, times, strand, mm = _single_from_ranked(ranked, max_mm)
        if times == 1:
            lines.append(mr_line(meta, pos, strand, mm, name, seq, qual, ag))
    return lines, "ambiguous" if best_times >= 2 else "unmapped"


# ---- the sample's expected records ------------------------------------------
class Reference:
    """WALT's exact answers for a sample, on the genome the benchmark made.

    ``flags``: the configuration's ``-m``, ``-b``, ``-k``, ``-L``.
    ``device``: where the bucket index is computed (plain PyTorch)."""

    def __init__(self, genome, pattern: str, flags: dict, device="cpu"):
        self.meta = Meta(genome.names, genome.lengths, genome.start_index)
        self.seq = genome.seq
        self.start_index = np.asarray(genome.start_index)
        self.pattern = PATTERNS[pattern]
        self.m, self.b = int(flags["m"]), int(flags["b"])
        self.k, self.L = int(flags.get("k", 50)), int(flags.get("L", 1000))
        self.device = device

    def _table(self, name, reads, ag_wildcard):
        conv = converted(self.seq, self.start_index, name)
        keys = set()
        for r in reads:
            if r.shape[0] >= self.pattern.min_read_len:
                keys.update(read_keys(convert_read(r, ag_wildcard),
                                      self.pattern))
        buckets = bucket_index(conv, self.start_index, keys, self.pattern,
                               self.device)
        pad = self.pattern.cared[-1] + 2
        return (np.concatenate([conv, np.full(pad, LOOKUP_PAD,
                                              dtype=np.uint8)]),
                self.start_index, buckets)

    def single_end(self, reads, names, shifts=None):
        """Per read: (MR line or None, class)."""
        t = [self._table(n, reads, False) for n in ("CT00", "CT01")]
        out = []
        for r, name in zip(reads, names):
            if r.shape[0] < self.pattern.min_read_len:
                out.append((None, "too_short"))
                continue
            streams = [(s, candidates(r, tb, False, self.b, self.m,
                                      self.pattern, shifts))
                       for s, tb in zip("+-", t)]
            pos, times, strand, mm = best_single(streams, self.m,
                                                 self.pattern)
            if times == 1:
                seq = CODE_TO_BASE[r].tobytes()
                out.append((mr_line(self.meta, pos, strand, mm, name, seq,
                                    b"I" * len(seq), False), "unique"))
            else:
                out.append((None, "ambiguous" if times else "unmapped"))
        return out

    def paired_end(self, reads1, reads2, names, shifts=None):
        """Per pair: (MR lines, class, order_dependent)."""
        t1 = [self._table(n, reads1, False) for n in ("CT00", "CT01")]
        t2 = [self._table(n, reads2, True) for n in ("GA10", "GA11")]
        out = []
        for r1, r2, name in zip(reads1, reads2, names):
            ranked, dep = [], False
            for r, tabs, ag in ((r1, t1, False), (r2, t2, True)):
                streams = [(s, candidates(r, tb, ag, self.b, self.m,
                                          self.pattern, shifts))
                           for s, tb in zip("+-", tabs)]
                rk, d = ranked_mate(streams, self.m, self.k, self.pattern)
                ranked.append(rk)
                dep |= d
            s1, s2 = CODE_TO_BASE[r1].tobytes(), CODE_TO_BASE[r2].tobytes()
            lines, cls = pair_lines(self.meta, ranked[0], ranked[1], name,
                                    s1, b"I" * len(s1), s2, b"I" * len(s2),
                                    self.L, self.m)
            out.append((lines, cls, dep))
        return out
