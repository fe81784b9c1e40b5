"""Device-memory table planning: what fits on a card, and how hg19 deploys.

Port of ``walt_tpu/hbm_plan.py``.  Tables are device-resident, so the
capacity question is: given a genome size, how many cards (tp width) and
which per-table acceleration structure (uniq run index or key16 prefixes)
fit each card's memory?  :func:`plan_tables` is the calculator and
:class:`TablePlan` the result; the backend's single-device ladder
(``core/torch_backend._build_single_device_table``) makes the same choices
at run time with the real run count.

Byte model per converted-genome table (n = genome_bp entries, u32
positions), the JAX package's:

- packed genome ``pseq``: n/4 bytes, replicated on every tp shard (a shard
  verifies windows anywhere in the genome);
- CSR ``counter``: 4 (4^12 + 1) bytes; ``index``: 4n bytes; bucket flags:
  4^12 bytes -- tp-sharded by bucket range;
- uniq run index: 8U + 4 (4^12 + 1) bytes, U = word-0 runs (U/n = 0.93 on
  the JAX package's 512 Mbp repeat-structured genome, at most 1.0) -- or
  the key16 prefix table, 2n bytes (12n more for the 3-word keys of runs
  whose -b is below the verify slabs) -- tp-sharded.

Two limits decide tp.  The memory budget is the card's memory less the
backend's reserve (``TorchBackend.HBM_RESERVE``, measured on the card).  The
entry limit: the pipeline's entry indices are int32, so each tp shard must
hold fewer than ``pipeline.ENTRY_LIMIT`` (2^31) entries, which the runtime
enforces per table and per shard (``parallel/sharded._shard_bounds``).
The plan bounds the heaviest shard (:func:`heaviest_shard`) and sizes
each card's bytes: the per-bucket arrays (counters, flags) by each card's
share of every table's buckets (:func:`bucket_shares`), the per-entry
arrays (index, uniq runs or key16 prefixes) by its share of every table's
entries (:func:`card_shares`), and the plan holds the heaviest card.
Given the tables' counters, the shares are the runtime's own split of them
(``parallel/sharded.balanced_bounds``: bucket ranges of about N/tp entries
each).  From the genome size alone the plan bounds the runtime's heaviest
card from above: each table's per-bucket arrays count on every card at
the share of a human table's heaviest range under the runtime's split
(:func:`_model_bucket_shares`: a range of few entries spans many
buckets, 0.76 of a C->T table at tp=2), and the entries are a human
genome's under
walt_tpu's split into equal bucket-key ranges (:func:`_model_shares`),
whose heaviest card holds more than the runtime's: a C->T table has no C
and a G->A table no G, so at tp=4 that split puts about half of each C->T
table on the T-range card, and hg19 SE's heaviest card carries about twice
the even split's bytes (walt_tpu's plan splits them evenly).  On a 16 GiB
device memory binds first and the entry limit never does.  On an 80 GB
card the limit binds first: one card would hold hg19's 3.1e9-entry SE
tables with the uniq index, but no int32 index reaches their entries, and
the model's heavier of two shards holds ~70% of them (2.2e9, past 2^31
too), so the size-only plan deploys hg19 at tp=4.
"""

from __future__ import annotations

import argparse
import dataclasses
import math

import numpy as np
import torch

from walt_tpu_torch.index.build import CONVERSIONS
from walt_tpu_torch.ops import pipeline

NB1 = 4**12 + 1  # CSR counter entries (pattern 3 key weight 12)
#: GC content of the human genome (hg19: 40.9%), which planning from the
#: genome size alone assumes
HUMAN_GC = 0.41
#: added to each modelled share, so that it bounds a real table's
_SHARE_MARGIN = 0.01


@dataclasses.dataclass
class TablePlan:
    genome_bp: int
    n_tables: int          # resident tables (2 SE, 4 PE)
    tp: int                # table shards (cards) the plan needs
    uniq: bool             # word-0 run index built?
    key_words: int         # packed key words stored (0 when uniq)
    per_table_base: int    # bytes: pseq + counter + index + flags
    per_table_accel: int   # bytes: uniq or key words
    per_chip_bytes: int    # resident bytes on the heaviest card
    hbm_bytes: int
    reserve: int

    def fits(self) -> bool:
        return self.per_chip_bytes <= self.hbm_bytes - self.reserve


def table_bytes(genome_bp: int, uniq_ratio: float = 1.0):
    """(base, uniq, key16) byte sizes for one table."""
    n = genome_bp
    pseq = n // 4 + 272  # + packed tail words
    counter = 4 * NB1
    index = 4 * n
    flagged = NB1 - 1
    base = pseq + counter + index + flagged
    uniq = int(8 * n * uniq_ratio) + 4 * NB1
    kw16 = 2 * n
    return base, uniq, kw16


def device_memory(device=None) -> int:
    """Total memory of a CUDA card in bytes, as ``torch.cuda.mem_get_info``
    reports it; raises when there is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("hbm_plan: no CUDA device is available; pass "
                           "hbm_bytes")
    return int(torch.cuda.mem_get_info(device)[1])


def _strand_bases(conversion: str) -> tuple:
    """(A, C, G, T) shares of a human genome's converted strand: a strand
    holds about as much A as T and C as G; a C->T table reads every C as
    T, a G->A table every G as A."""
    at, gc = (1 - HUMAN_GC) / 2, HUMAN_GC / 2
    if conversion.startswith("CT"):
        return at, 0.0, gc, at + gc
    return at + gc, gc, 0.0, at


def _model_shares(tp: int, conversion: str) -> np.ndarray:
    """Share of a human ``conversion`` table's entries on each of ``tp`` (a
    power of two) bucket-range shards under walt_tpu's split.

    walt_tpu splits the 4^12 buckets into tp equal key ranges, and a
    key's top bits are its position's first cared bases, two bits each (A <
    C < G < T, ``index/build.seed_keys``): shard c's top bits are c's.  A
    whole base takes its share; a last single bit takes its half of the
    alphabet ({A, C} or {G, T}).  The bases are taken as independent, and
    each factor carries a margin of ``_SHARE_MARGIN``.
    """
    k = tp.bit_length() - 1
    p = _strand_bases(conversion)
    out = np.ones(tp)
    for c in range(tp):
        for j in range(k // 2):
            out[c] *= p[(c >> (k - 2 * (j + 1))) & 3] + _SHARE_MARGIN
        if k % 2:
            h = c & 1
            out[c] *= p[2 * h] + p[2 * h + 1] + _SHARE_MARGIN
    return np.minimum(out, 1.0)


def _model_bucket_shares(tp: int, conversion: str) -> np.ndarray:
    """Share of a human ``conversion`` table's buckets on each of ``tp``
    shards of the runtime's split (``parallel/sharded.balanced_bounds``),
    each with a margin of ``_SHARE_MARGIN``.

    Cut t falls where the table's entries reach t/tp of them.  With a
    key's bases independent (:func:`_model_shares`), the key below a share
    q of the entries follows base by base, two bits each: the base in whose
    range q falls, then q within that range.  A cut that meets a range of
    no entries (a C->T table's C, a G->A table's G) falls at its start, as
    the runtime's does, so the range goes to the shard above.
    """
    p = _strand_bases(conversion)
    cuts = [0.0]
    for t in range(1, tp):
        q, key, width = t / tp, 0.0, 1.0
        for _ in range(12):  # a key's bases
            width /= 4
            b = 0
            while b < 3 and (q > p[b] or p[b] == 0):
                q -= p[b]
                b += 1
            key += b * width
            q /= p[b]
        cuts.append(key)
    return np.minimum(np.diff(cuts + [1.0]) + _SHARE_MARGIN, 1.0)


def heaviest_share(tp: int) -> float:
    """Share of a table's entries on the heaviest of ``tp`` (a power of two)
    equal bucket-key ranges of a human genome, which bounds the runtime's
    entry-balanced split from above: at tp=2 the heavier shard holds
    {G, T} of a C->T table ({A, C} of a G->A one), 1 - A = 0.5 + GC/2
    (0.705 for hg19); at tp=4 one base, T + C (A + G), 0.5; each wider
    split takes the next key bit the same way (:func:`_model_shares`)."""
    return float(_model_shares(tp, "CT00").max())


def _runtime_split(tp: int, counters) -> list:
    """(bucket bounds, entry bounds) of each table's tp split, the
    runtime's own (``parallel/sharded.balanced_bounds``)."""
    from walt_tpu_torch.parallel.sharded import balanced_bounds

    return [balanced_bounds(c, tp) for c in counters]


def card_shares(tp: int, n_tables: int, counters=None) -> np.ndarray:
    """(n_tables, tp) share of each resident table's entries on each of the
    ``tp`` cards: the runtime's own split of ``counters`` (the tables' CSR
    counters) when given, else a human genome's under walt_tpu's equal
    bucket-key ranges (:func:`_model_shares`), the tables taken in
    ``index/build.CONVERSIONS`` order (SE: CT00, CT01; PE: all four)."""
    if counters is not None:
        return np.array([np.diff(eb) / max(1, int(c[-1])) for (_, eb), c
                         in zip(_runtime_split(tp, counters), counters)])
    return np.array([_model_shares(tp, conv)
                     for conv in CONVERSIONS[:n_tables]])


def bucket_shares(tp: int, n_tables: int, counters=None) -> np.ndarray:
    """(n_tables, tp) share of each resident table's buckets on each of the
    ``tp`` cards: the runtime's own split of ``counters`` when given, else
    on every card the share of a human table's heaviest shard
    (:func:`_model_bucket_shares`), since any card may hold it."""
    if counters is not None:
        return np.array([np.diff(kb) / (len(c) - 1) for (kb, _), c
                         in zip(_runtime_split(tp, counters), counters)])
    return np.array([np.full(tp, _model_bucket_shares(tp, conv).max())
                     for conv in CONVERSIONS[:n_tables]])


def heaviest_shard(genome_bp: int, tp: int, counters=None) -> int:
    """Entries on the heaviest of ``tp`` shards of the largest table.

    ``counters``: the resident tables' CSR counters; the shards are then
    the runtime's own split of them (``parallel/sharded.balanced_bounds``),
    for a genome of any composition.  Without them, ``genome_bp`` entries
    per table shared as :func:`heaviest_share` says for a human genome.
    """
    if counters is not None:
        return max(int(np.diff(eb).max())
                   for _, eb in _runtime_split(tp, counters))
    return math.ceil(genome_bp * heaviest_share(tp))


def card_bytes(genome_bp: int, n_tables: int, tp: int, uniq: bool = True,
               uniq_ratio: float = 1.0, b_small: bool = False,
               counters=None) -> int:
    """Resident table bytes on the heaviest of ``tp`` cards.

    The packed genome words are replicated on every card; the per-bucket
    arrays (counter and flags, and the uniq run counter) follow each
    card's share of every table's buckets (:func:`bucket_shares`), the
    per-entry arrays (index, and the uniq runs or key16 prefixes, and the
    exact_b key words when ``b_small``) its share of every table's entries
    (:func:`card_shares`), both of ``counters``, else of a human genome's
    ``n_tables`` tables.  With every share 1/tp this is walt_tpu's even
    split.
    """
    base, uq, kw16 = table_bytes(genome_bp, uniq_ratio)
    pseq = genome_bp // 4 + 272
    buckets = 4 * NB1 + NB1 - 1 + (4 * NB1 if uniq else 0)
    entries = (base - pseq + (uq if uniq else kw16) - buckets
               + (12 * genome_bp if b_small else 0))
    per_card = (buckets * bucket_shares(tp, n_tables, counters).sum(axis=0)
                + entries * card_shares(tp, n_tables, counters).sum(axis=0))
    return n_tables * pseq + int(per_card.max())


def plan_tables(genome_bp: int, n_tables: int = 2,
                hbm_bytes: int | None = None, reserve: int | None = None,
                uniq_ratio: float = 1.0, b_small: bool = False,
                max_tp: int = 64, counters=None,
                entry_limit: int | None = None) -> TablePlan:
    """Smallest tp width (power of two) that fits, preferring uniq.

    ``hbm_bytes``: each card's memory (default :func:`device_memory` of the
    current card); ``reserve``: the mapping working set kept free on top of
    the tables (default ``TorchBackend.HBM_RESERVE``).  ``b_small``: the run
    uses -b below the verify slabs, so the exact_b path needs all 3 packed
    key words (12n/table) regardless of uniq.  A width whose heaviest shard
    (:func:`heaviest_shard` of ``counters``, else of ``genome_bp``) would
    hold ``entry_limit`` entries or more is skipped (default
    ``pipeline.ENTRY_LIMIT``; a smaller one rehearses, on a small genome,
    a deployment whose tp the limit decides, as hg19's on an 80 GB card).
    A width fits when its heaviest card (:func:`card_bytes`) does.
    """
    if hbm_bytes is None:
        hbm_bytes = device_memory()
    if reserve is None:
        from walt_tpu_torch.core.torch_backend import TorchBackend

        reserve = TorchBackend.HBM_RESERVE
    if entry_limit is None:
        entry_limit = pipeline.ENTRY_LIMIT
    base, uniq, kw16 = table_bytes(genome_bp, uniq_ratio)
    budget = hbm_bytes - reserve

    tp = 1
    while tp <= max_tp:
        if heaviest_shard(genome_bp, tp, counters) >= entry_limit:
            tp *= 2
            continue
        for use_uniq, accel in ((True, uniq), (False, kw16)):
            per_card = card_bytes(genome_bp, n_tables, tp, use_uniq,
                                  uniq_ratio, b_small, counters)
            if per_card <= budget:
                return TablePlan(genome_bp, n_tables, tp, use_uniq,
                                 3 if b_small else int(not use_uniq), base,
                                 accel, per_card, hbm_bytes, reserve)
        tp *= 2
    raise ValueError(
        f"{genome_bp} bp x {n_tables} tables does not fit {max_tp} shards"
    )


def describe(plan: TablePlan) -> str:
    g = 1 << 30
    return (
        f"{plan.genome_bp / 1e9:.2f} Gbp x {plan.n_tables} tables: "
        f"tp={plan.tp}, {'uniq run index' if plan.uniq else 'key16 prefix'}, "
        f"base {plan.per_table_base / g:.2f} GiB + accel "
        f"{plan.per_table_accel / g:.2f} GiB per table, "
        f"{plan.per_chip_bytes / g:.2f} GiB/card of "
        f"{(plan.hbm_bytes - plan.reserve) / g:.2f} GiB budget"
    )


#: (genome bp, resident tables, label) of the deployments the plan prints:
#: hg19 (3.1 Gbp) SE and PE, and chip_smoke's shifted 2.24 Gbp genome
DEPLOYMENTS = ((3_100_000_000, 2, "hg19 SE"), (3_100_000_000, 4, "hg19 PE"),
               (2_243_483_648, 2, "2.24 Gbp SE"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Print the table plans of hg19 SE/PE and a 2.24 Gbp SE "
                    "genome for one card's memory.")
    ap.add_argument("--hbm-gib", type=float, default=None,
                    help="card memory in GiB (default: the current card's)")
    args = ap.parse_args(argv)
    hbm = (device_memory() if args.hbm_gib is None
           else int(args.hbm_gib * (1 << 30)))
    for bp, nt, label in DEPLOYMENTS:
        print(f"{label:>12}: "
              f"{describe(plan_tables(bp, nt, hbm, uniq_ratio=0.93))}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
