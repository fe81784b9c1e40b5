"""Is what the window wrote correct?

After the window, a sample of the pool's reads (or pairs) that the window
fed, drawn from the seed, is mapped by the plain reference
(``portbench.reference``).  Each sampled read's records in the window's MR
output, over every time the cycled pool fed it, must be the reference's
records byte for byte, as many times as it was fed; a read the reference
leaves unmapped, ambiguous or too short must have none.  The ``.mapstats``
counts are held to what the benchmark fed and to the records written.

Numbers compared, each with its limit (all exact, limit 0):

- ``records_wrong``: sampled reads or pairs whose records differ;
- ``stats_total_gap``: |total reads or pairs in .mapstats - fed|;
- ``stats_unique_gap``: |records the counts say were written - MR lines|;
- ``stats_short_gap``: |too_short - 2 x fed reads (or mates) shorter than
  the pattern's minimum| (each counts once per strand pass);
- ``stats_frag_gap`` (PE): the fragment-length histogram against the
  fragment lines' lengths, summed absolute difference.
"""

from __future__ import annotations

import re
from collections import Counter

import numpy as np

from portbench import gen, reference

LIMITS = {"records_wrong": 0, "stats_total_gap": 0, "stats_unique_gap": 0,
          "stats_short_gap": 0, "stats_frag_gap": 0}


def _ints(arr, s, e):
    """The decimal numbers arr[s:e] of each row (s, e arrays); None when a
    field holds anything but digits."""
    out = np.zeros(s.shape[0], dtype=np.int64)
    for d in range(12):
        p = e - 1 - d
        ok = p >= s
        dig = arr[np.where(ok, p, 0)].astype(np.int64) - 48
        if np.any(ok & ((dig < 0) | (dig > 9))):
            return None
        out += np.where(ok, dig, 0) * 10 ** d
    return out


class Records:
    """The MR lines of an output buffer, parsed without copying it: each
    line's bounds, the pool index its read name (``r<i>`` or
    ``FRAG:r<i>``) carries, and whether it is a fragment line.
    ``ok`` is False when the buffer is not whole MR lines."""

    def __init__(self, data):
        arr = np.frombuffer(data, dtype=np.uint8)
        self.arr, self.ok, self.n = arr, True, 0
        self.idx = np.zeros(0, dtype=np.int64)
        self.frag = np.zeros(0, dtype=bool)
        if arr.size == 0:
            return
        nl = np.flatnonzero(arr == 10)
        tabs = np.flatnonzero(arr == 9)
        if nl.size == 0 or nl[-1] != arr.size - 1 or \
                tabs.size != 7 * nl.size:
            self.ok = False
            return
        tabs = tabs.reshape(-1, 7)
        starts = np.concatenate([[0], nl[:-1] + 1])
        if np.any(tabs[:, 0] < starts) or np.any(tabs[:, 6] > nl):
            self.ok = False
            return
        n0, n1 = tabs[:, 2] + 1, tabs[:, 3]
        frag = arr[n0] == ord("F")
        idx = _ints(arr, n0 + np.where(frag, 6, 1), n1)
        if idx is None:
            self.ok = False
            return
        self.starts, self.ends, self.tabs = starts, nl + 1, tabs
        self.idx, self.frag, self.n = idx, frag, nl.size

    def line(self, j: int) -> bytes:
        return self.arr[self.starts[j]: self.ends[j]].tobytes()

    def frag_lengths(self):
        """end - start of each fragment line; None when not numbers."""
        t = self.tabs[self.frag]
        a = _ints(self.arr, t[:, 0] + 1, t[:, 1])
        b = _ints(self.arr, t[:, 1] + 1, t[:, 2])
        return None if a is None or b is None else b - a


def _count(stats: str, key: str, nth: int = 0) -> int:
    got = re.findall(rf"(?<!\w){key}: (-?\d+)\b", stats)
    return int(got[nth]) if len(got) > nth else -1


def sample_indices(n_fed: int, pool_n: int, size: int, seed: int):
    rng = np.random.default_rng([seed, 3])
    top = min(n_fed, pool_n)
    return np.sort(rng.choice(top, size=min(size, top), replace=False))


def expected(genome, config, traffic, pool, idx, device, shifts=None):
    """The reference's (lines, judged) per sampled index."""
    ref = reference.Reference(genome, str(config["seed_pattern"]),
                              config["flags"], device)
    names = [gen.read_name(i) for i in idx]
    if traffic["mode"] == "se":
        got = ref.single_end([pool.read(0, i) for i in idx], names, shifts)
        return [([line] if line else [], True) for line, _ in got]
    got = ref.paired_end([pool.read(0, i) for i in idx],
                         [pool.read(1, i) for i in idx], names, shifts)
    return [(lines, not dep) for lines, _, dep in got]


def check(genome, config, traffic, pool, data: bytes, stats: str,
          n_fed: int, seed: int, ref_device: str = "cpu",
          exp=None) -> dict:
    """The numbers compared, each beside its limit, and ``correct``.
    ``exp``: the reference's answers for the sample, when they are at hand
    already (the control); else they are worked out here."""
    pe = traffic["mode"] == "pe"
    P = pool.n
    idx = sample_indices(n_fed, P, int(traffic["sample"]), seed)
    if exp is None:
        exp = expected(genome, config, traffic, pool, idx, ref_device)
    rec = Records(data)
    numbers = {}
    missing = unjudged = 0
    if not rec.ok:
        numbers["records_wrong"] = len(idx)
    else:
        by_idx = {}
        for j in np.flatnonzero(np.isin(rec.idx, idx)).tolist():
            by_idx.setdefault(int(rec.idx[j]), []).append(rec.line(j))
        wrong = 0
        for i, (want, judged) in zip(idx.tolist(), exp):
            if not judged:
                unjudged += 1
                continue
            occ = n_fed // P + (i < n_fed % P)
            got = sorted(by_idx.get(i, []))
            if got != sorted(want * occ):
                wrong += 1
                if len(got) < len(want) * occ:
                    missing += 1
        numbers["records_wrong"] = wrong
    minimum = reference.PATTERNS[str(config["seed_pattern"])].min_read_len
    n_short = 0
    for _, lens in pool.mates:
        short = lens < minimum
        cyc = int(short.sum()) * (n_fed // P) + int(short[: n_fed % P].sum())
        n_short += cyc
    if pe:
        total = _count(stats, "total_read_pairs")
        uniq = (_count(stats, "unique") + _count(stats, "unique", 1)
                + _count(stats, "unique", 2))
        too_short = _count(stats, "too_short") + _count(stats, "too_short",
                                                       1)
        hist = Counter({int(a): int(b) for a, b in
                        re.findall(r"\n    (\d+): (\d+)", stats)})
        fl = rec.frag_lengths() if rec.ok else None
        got = Counter(fl.tolist()) if fl is not None else Counter()
        numbers["stats_frag_gap"] = sum(abs(hist[k] - got[k])
                                        for k in set(hist) | set(got))
    else:
        total = _count(stats, "total_reads")
        uniq = _count(stats, "unique")
        too_short = _count(stats, "too_short")
    numbers["stats_total_gap"] = abs(total - n_fed)
    numbers["stats_unique_gap"] = abs(uniq - rec.n)
    numbers["stats_short_gap"] = abs(too_short - 2 * n_short)
    out = [{"name": k, "value": int(v), "limit": LIMITS[k]}
           for k, v in numbers.items()]
    return dict(correct=all(o["value"] <= o["limit"] for o in out),
                numbers=out, missing=missing, sampled=len(idx),
                unjudged=unjudged)
