"""Sequential best-hit / top-k semantics, replayed over candidate streams.

The device pipeline produces, for each read and each strand table, an
*ordered stream* of verified candidates: ``(seed_i, genome_pos,
true_mismatches)`` with true_mismatches <= max_mismatches, ordered exactly as
the reference examines them (seed shift ascending, bucket position
ascending), with candidates from capped seeds (refined region > -b) already
removed.  This module folds those streams through the reference's sequential
state machines:

- single-end: ``BestMatch`` tracking with its order-dependent ``times``
  counting (mapping.cpp:224-316) -- a strictly better candidate resets
  times=1; an equal-count candidate at a *different* position than the one
  currently stored overwrites it and increments times;
- paired-end: the bounded top-k max-heap (paired.hpp:51-74) and the seed
  early-exit rules (paired.cpp:131-149).

Feeding true mismatch counts is equivalent to the reference's early-broken
counts: a count that the reference would under-report is by construction
rejected by both state machines (see SURVEY.md 2.5.4).

Seed early-exits (mapping.cpp:248-263) are replayed by re-evaluating the
gate whenever the stream crosses a (strand, seed) boundary, which is exactly
when the reference evaluates it.
"""

from __future__ import annotations

import dataclasses

from walt_tpu_torch.constants import SeedPattern
from walt_tpu_torch.host.heap import TopCandidates

UINT32_MAX = 0xFFFFFFFF

#: host-side worker threads for the exact fallback/oracle paths; the -t flag
#: maps here (the reference's OpenMP thread count, walt.cpp:165-166).  Device
#: parallelism is the mesh; this only keeps a fallback spike (repeat-heavy
#: reads the fixed device shapes cannot hold) from serializing the pipeline.
_host_threads = 1
_pool = None


def set_host_threads(n: int) -> None:
    global _host_threads, _pool
    n = max(1, int(n))
    if n != _host_threads and _pool is not None:
        _pool.shutdown(wait=False)
        _pool = None
    _host_threads = n


def host_map(fn, items):
    """Map ``fn`` over ``items`` on the -t thread pool, preserving order.

    The per-item work is NumPy-heavy (refmap window gathers release the
    GIL), so threads overlap it; results come back in input order so the
    sequential emission semantics are untouched.
    """
    global _pool
    items = list(items)
    if _host_threads <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    if _pool is None:
        from concurrent.futures import ThreadPoolExecutor

        _pool = ThreadPoolExecutor(_host_threads)
    return list(_pool.map(fn, items))


@dataclasses.dataclass
class BestMatch:
    """mapping.hpp:39-52."""

    genome_pos: int = 0
    times: int = 0
    strand: str = "+"
    mismatch: int = UINT32_MAX


def _seed_allowed(best_mismatch: int, seed_i: int, exit1_seed: int) -> bool:
    """Gate at the top of the seed loop (mapping.cpp:248-263)."""
    if best_mismatch == 0 and seed_i:
        return False
    if best_mismatch == 1 and seed_i >= exit1_seed:
        return False
    return True


def replay_single(streams, max_mismatches: int, pattern: SeedPattern) -> BestMatch:
    """Fold SE candidate streams into a BestMatch.

    ``streams``: iterable of (strand_char, candidates) in file order
    ('+' table then '-' table, mapping.cpp:491-499); candidates is an
    iterable of (seed_i, genome_pos, mismatches) in examination order.
    """
    bm = BestMatch(0, 0, "+", max_mismatches)
    for strand, cands in streams:
        prev_seed = -1
        allowed = True
        for seed_i, pos, mm in cands:
            if seed_i != prev_seed:
                allowed = _seed_allowed(bm.mismatch, seed_i, pattern.exit1_seed)
                prev_seed = seed_i
            if not allowed:
                continue
            if mm < bm.mismatch:
                bm = BestMatch(pos, 1, strand, mm)
            elif mm == bm.mismatch and bm.genome_pos != pos:
                bm.genome_pos = pos
                bm.strand = strand
                bm.times += 1
    return bm


def replay_paired_topk(streams, max_mismatches: int, top_k: int,
                       pattern: SeedPattern) -> list:
    """Fold PE candidate streams (one mate) into ranked results.

    Mirrors PairEndMapping pushes (paired.cpp:165-199) followed by the heap
    drain of paired.cpp:684-692.  Returns candidates as (mismatch, genome_pos,
    strand) tuples, in drain order (descending-ish mismatch, heap tie order).
    """
    heap = TopCandidates(top_k)
    for strand, cands in streams:
        prev_seed = -1
        allowed = True
        for seed_i, pos, mm in cands:
            if seed_i != prev_seed:
                if heap.empty() or not heap.full():
                    allowed = True
                else:
                    allowed = _seed_allowed(heap.top()[0], seed_i, pattern.exit1_seed)
                prev_seed = seed_i
            if not allowed:
                continue
            if mm > max_mismatches:
                continue
            heap.push((mm, pos, strand))
    return heap.drain()


def get_best_match_for_single(ranked, max_mismatches: int) -> BestMatch:
    """GetBestMatch4Single (paired.cpp:296-318).

    ``ranked`` is the drain-order list; the reference walks it from the last
    element (smallest mismatch) towards the front, breaking once mismatch
    exceeds the current best.
    """
    bm = BestMatch(0, 0, "+", max_mismatches)
    for mm, pos, strand in reversed(ranked):
        if mm < bm.mismatch:
            bm = BestMatch(pos, 1, strand, mm)
        elif mm == bm.mismatch:
            if bm.genome_pos == pos:
                continue
            bm.genome_pos = pos
            bm.strand = strand
            bm.times += 1
        else:
            break
    return bm
