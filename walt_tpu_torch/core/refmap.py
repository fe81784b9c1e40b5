"""Exact host-side candidate enumeration (NumPy).

This is the executable specification of the reference's seeding semantics
(``src/walt/mapping.cpp:166-316``): for each read and seed shift, hash the
first 12 cared bases, refine the bucket by binary search over the remaining
cared positions, apply the -b candidate cap, then verify every refined entry.

The device pipeline (walt_tpu_torch.ops) must produce identical candidate streams;
this module doubles as its fallback for reads the fixed device shapes cannot
hold and as the oracle in differential tests.

Verification uses the key identity derived in SURVEY/the pattern tables:
after refinement, every cared position of the seed matches by construction,
so the reference's no-cared + tail mismatch count equals the full Hamming
distance between converted read and converted genome window, minus the
pattern's typo'd skip positions (constants.SeedPattern.verify_skip).
"""

from __future__ import annotations

import numpy as np

from walt_tpu_torch.constants import SeedPattern, get_pattern
from walt_tpu_torch.genome import Genome
from walt_tpu_torch.index.build import HashTable

#: code written into the lookup pad past the end of the genome.  The
#: reference reads out-of-bounds heap bytes there (undefined); any fixed
#: value is a defined stand-in.  Sorts above every real base.
LOOKUP_PAD = np.uint8(200)


_padded_cache = {}


def padded_seq(genome: Genome, pattern: SeedPattern) -> np.ndarray:
    """Genome codes padded so seed comparisons never index out of range.

    Cached per (genome, pad): the copy is ~1 GB at hg19 scale and the host
    fallback path calls this once per read otherwise.  The cache holds the
    genome by WEAK reference with an eviction callback, so (a) a dead
    genome's id cannot alias a stale entry and (b) dropping the genome
    (e.g. between bench configs) frees the padded copy too.
    """
    import weakref

    pad = int(pattern.cared[-1]) + 2
    key = (id(genome), pad)
    got = _padded_cache.get(key)
    if got is None:
        ref = weakref.ref(genome, lambda _r: _padded_cache.pop(key, None))
        got = (ref, np.concatenate(
            [genome.seq, np.full(pad, LOOKUP_PAD, dtype=np.uint8)]
        ))
        _padded_cache[key] = got
    return got[1]


def convert_read(codes: np.ndarray, ag_wildcard: bool) -> np.ndarray:
    """C->T, or G->A under the A/G wildcard (mapping.cpp:142-164)."""
    if ag_wildcard:
        return np.where(codes == 2, np.uint8(0), codes)
    return np.where(codes == 1, np.uint8(3), codes)


def _index_region(read: np.ndarray, seq: np.ndarray, ht: HashTable,
                  seed_len: int, lo: int, hi: int, pattern: SeedPattern):
    """IndexRegion + Lower/UpperBound (mapping.cpp:166-222), exact.

    ``read`` is the shifted converted read (read[seed_i:]); [lo, hi) is the
    bucket.  Returns inclusive (l, u) or None when empty.
    """
    index = ht.index
    l, u = lo, hi - 1
    for p in range(pattern.key_weight, seed_len):
        cp = int(pattern.cared[p])
        c = read[cp]
        # LowerBound (mapping.cpp:166-180)
        low, high = l, u
        while low < high:
            mid = low + (high - low) // 2
            if seq[int(index[mid]) + cp] >= c:
                high = mid
            else:
                low = mid + 1
        l = low
        # UpperBound (mapping.cpp:182-196)
        low, high = l, u
        while low < high:
            mid = low + (high - low + 1) // 2
            if seq[int(index[mid]) + cp] <= c:
                low = mid
            else:
                high = mid - 1
        u = low
        if l == u and seq[int(index[l]) + cp] != c:
            return None
    if l > u:
        return None
    return l, u


def enumerate_candidates(read_codes: np.ndarray, genome: Genome, ht: HashTable,
                         ag_wildcard: bool, b: int, max_mismatches: int,
                         pattern: SeedPattern | None = None,
                         seq_padded: np.ndarray | None = None):
    """Ordered candidate stream for one read against one table.

    Yields (seed_i, genome_pos, true_mismatches) with true_mismatches <=
    max_mismatches, in the reference's examination order.  Seeds whose
    refined region exceeds ``b`` yield nothing (mapping.cpp:275-277).
    """
    pattern = pattern or get_pattern("3")
    read_len = int(read_codes.shape[0])
    if read_len < pattern.min_read_len:
        return
    seq = seq_padded if seq_padded is not None else padded_seq(genome, pattern)
    start_index = genome.start_index.astype(np.int64)
    read = convert_read(read_codes, ag_wildcard)
    # the hash keys of a read shorter than key_span read base code 0 past
    # its end, as the native exact path and the device do
    keyed = read
    if read_len < pattern.key_span:
        keyed = np.zeros(pattern.key_span, dtype=np.uint8)
        keyed[:read_len] = read

    repeats = int(pattern.repeats_for_len(read_len))
    seed_len = int(pattern.seed_len_for_len(read_len))

    for seed_i in range(pattern.pattern_len):
        shifted = keyed[seed_i:]
        # hash key over cared[0..key_weight) of the shifted read
        key = 0
        for i in range(pattern.key_weight):
            key = (key << 2) | int(shifted[int(pattern.cared[i])])
        lo, hi = int(ht.counter[key]), int(ht.counter[key + 1])
        if lo == hi:
            continue
        region = _index_region(shifted, seq, ht, seed_len, lo, hi, pattern)
        if region is None:
            continue
        l, u = region
        if u - l + 1 > b:
            continue
        # vectorized verification of the whole refined region
        entries = ht.index[l : u + 1].astype(np.int64)
        chr_id = np.searchsorted(start_index, entries, side="right") - 1
        ok = (entries - start_index[chr_id]) >= seed_i
        gpos = entries - seed_i
        ok &= (gpos + read_len) < start_index[chr_id + 1]
        win = seq[gpos[:, None] + np.arange(read_len)]
        mm = np.count_nonzero(win != read, axis=1).astype(np.int64)
        # pattern-typo corrections (see constants.SeedPattern.verify_skip)
        for shift, min_rep, p in pattern.verify_skip:
            if seed_i == shift and repeats >= min_rep:
                mm -= (win[:, p] != read[p]).astype(np.int64)
        ok &= mm <= max_mismatches
        for j in np.flatnonzero(ok):
            yield seed_i, int(gpos[j]), int(mm[j])
