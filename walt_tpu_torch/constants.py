"""Seed-pattern tables and nucleotide codecs.

The reference selects one of three periodic spaced seeds at compile time
(``src/walt/seedpattern.hpp``, chosen via ``-D SEEDPATTERN{3,5,7}`` in
``src/walt/Makefile:34``; pattern 3 is the shipped default).  Here the pattern
is a runtime choice: each pattern is a small table of integer constants, so
nothing else about the mapper changes.

The tables are *generated* from the periodic definition ("010" repeated for
pattern 3, etc.) and then patched with the handful of hand-typed deviations
present in the reference header.  Two of those deviations are load-bearing for
bit-exact parity (see ``VERIFY_SKIP`` below): for seed shift 2 of pattern 3,
the no-cared table lists position 60 where the periodic pattern says 70
(``seedpattern.hpp:451``) and 141 where it says 142 (``seedpattern.hpp:453``).
Both typo'd values are *cared* positions (guaranteed equal after bucket
refinement), so the net observable effect is that a mismatch at read position
70 (reads >= 71bp) or 142 (reads >= 143bp) is invisible to a shift-2 seed.
The mapper must reproduce that to match the reference read-for-read.

Nucleotide codec: A=0, C=1, G=2, T=3 (``src/walt/util.hpp:107-121``).  This
ordering coincides with ASCII order of 'A' < 'C' < 'G' < 'T', so integer
comparisons on codes reproduce the reference's byte comparisons on sequence
characters (used by bucket sorting and binary-search refinement).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

# ---------------------------------------------------------------------------
# Nucleotide codec
# ---------------------------------------------------------------------------

#: Maps A/C/G/T (upper case) to 0..3; everything else to 255.
BASE_TO_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    BASE_TO_CODE[_b] = _i

#: Maps 0..3 to A/C/G/T bytes.
CODE_TO_BASE = np.frombuffer(b"ACGT", dtype=np.uint8).copy()

#: Complement of a 2-bit code: A<->T, C<->G  (3 - code).
CODE_COMPLEMENT = np.array([3, 2, 1, 0], dtype=np.uint8)

#: Code used for padding read/genome arrays.  Never equal to a real base and
#: never produced by the loaders (all non-ACGT input is randomized to a real
#: base first, matching ``util.hpp:156-163``).
PAD_CODE = np.uint8(254)

MAX_LINE_LENGTH = 1000  # util.hpp:43
WALT_VERSION = "1.0"  # util.hpp:41


# ---------------------------------------------------------------------------
# Seed patterns
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SeedPattern:
    """All constants derived from one periodic spaced-seed pattern.

    Mirrors the compile-time tables of ``src/walt/seedpattern.hpp`` with the
    same names (sans the F2 prefix) so parity tests can line the two up.
    """

    name: str
    period: tuple  # e.g. (0, 1, 0) -- 1 = cared position
    pattern_len: int  # SEEDPATTERNLEN: length of the period == number of shifts
    cared_weight: int  # cared positions per period
    nocared_weight: int  # no-cared positions per period
    min_read_len: int  # MINIMALREADLEN
    min_seed_len: int  # MINIMALSEEDLEN
    key_weight: int  # F2SEEDKEYWEIGHT: number of cared bases hashed (12)
    cared: np.ndarray  # F2CAREDPOSITION  (cared_size,)
    nocared: np.ndarray  # F2NOCAREDPOSITION  (pattern_len, max_row_len), -1 padded
    nocared_len: np.ndarray  # true row lengths of `nocared`
    # Verification-time corrections induced by typos in the reference tables:
    # list of (shift, min_repeats, read_position).  When mapping with seed
    # shift `shift` and the read's repeat count >= min_repeats, a mismatch at
    # `read_position` must be EXCLUDED from the count (the reference never
    # compares that position; see module docstring).
    verify_skip: tuple = ()
    # Early-exit rule (mapping.cpp:248-263): seeds past `exit0_after` are
    # skipped when a 0-mismatch hit exists; seeds >= `exit1_after` are skipped
    # when a 1-mismatch hit exists.
    exit1_seed: int = 2  # pattern 3/5: seed_i >= 2; pattern 7: seed_i >= 4

    @property
    def cared_size(self) -> int:
        return int(self.cared.shape[0])

    @property
    def n_buckets(self) -> int:
        return 4**self.key_weight

    @property
    def key_span(self) -> int:
        """Read length that holds the hash key of every seed shift: the last
        shift's last key base is ``pattern_len - 1 + cared[key_weight - 1]``.
        Pattern 7 reads of 23-24 bp are shorter; their keys read base code 0
        (A) past the read's end, on every path (the reference reads past
        its string there, which is undefined)."""
        return self.pattern_len + int(self.cared[self.key_weight - 1])

    def max_repeats(self) -> int:
        """Repeat cap applied by the reference (mapping.cpp:236-238)."""
        return 50

    def repeats_for_len(self, read_len) -> np.ndarray:
        """seed_pattern_repeats for a read length (mapping.cpp:236-239)."""
        r = (np.asarray(read_len) - self.pattern_len + 1) // self.pattern_len
        return np.minimum(r, self.max_repeats())

    def seed_len_for_len(self, read_len) -> np.ndarray:
        """Number of cared positions refined for a read length.

        ``seed_len = repeats * cared_weight`` (mapping.cpp:239).  Clamped to
        the cared table size: for patterns 5/7 with long reads the reference
        reads past the end of F2CAREDPOSITION (undefined behavior); we stop at
        the table edge, which is the only defined interpretation.
        """
        return np.minimum(
            self.repeats_for_len(read_len) * self.cared_weight, self.cared_size
        )


def _generate(
    name: str,
    period: tuple,
    min_read_len: int,
    min_seed_len: int,
    cared_size: int,
    nocared_lens: tuple,
    cared_patches: dict | None = None,
    nocared_patches: dict | None = None,
    verify_skip: tuple = (),
    exit1_seed: int = 2,
) -> SeedPattern:
    plen = len(period)
    cared = np.array(
        [p for p in range(8 * plen * cared_size) if period[p % plen] == 1][:cared_size],
        dtype=np.int32,
    )
    for i, v in (cared_patches or {}).items():
        cared[i] = v
    max_row = max(nocared_lens)
    nocared = np.full((plen, max_row), -1, dtype=np.int32)
    for s in range(plen):
        # Read position p (after shifting the pattern right by s) is no-cared
        # iff p < s (before the pattern starts) or the pattern bit is 0.
        row = [
            p
            for p in range(8 * plen * max_row)
            if p < s or period[(p - s) % plen] == 0
        ][: nocared_lens[s]]
        nocared[s, : len(row)] = row
    for (s, i), v in (nocared_patches or {}).items():
        nocared[s, i] = v
    return SeedPattern(
        name=name,
        period=period,
        pattern_len=plen,
        cared_weight=sum(period),
        nocared_weight=len(period) - sum(period),
        min_read_len=min_read_len,
        min_seed_len=min_seed_len,
        key_weight=12,
        cared=cared,
        nocared=nocared,
        nocared_len=np.array(nocared_lens, dtype=np.int32),
        verify_skip=verify_skip,
        exit1_seed=exit1_seed,
    )


@lru_cache(maxsize=None)
def get_pattern(name: str = "3") -> SeedPattern:
    """Return the seed pattern tables ('3' default, '5', '7')."""
    name = str(name)
    if name == "3":
        # seedpattern.hpp:354-456.  Four hand-typed deviations from the
        # periodic tables; entries (0,118) and (2,115) lie beyond the used
        # range (index < 2*repeats + shift, repeats <= 50) and are inert, but
        # are reproduced so the full tables match the reference byte-for-byte.
        return _generate(
            "3",
            (0, 1, 0),
            min_read_len=38,
            min_seed_len=36,
            cared_size=60,
            nocared_lens=(121, 121, 122),
            nocared_patches={(0, 118): 178, (2, 47): 60, (2, 95): 141, (2, 115): 171},
            # shift-2 typos: position 70 unchecked once repeats >= 23
            # (entry 47 in use), position 142 unchecked once repeats >= 47.
            verify_skip=((2, 23, 70), (2, 47, 142)),
            exit1_seed=2,
        )
    if name == "5":
        # seedpattern.hpp:226-352 (canonical periodic tables, no deviations).
        return _generate(
            "5",
            (1, 0, 1, 0, 0),
            min_read_len=32,
            min_seed_len=30,
            cared_size=56,
            nocared_lens=(84, 85, 86, 87, 88),
            exit1_seed=2,
        )
    if name == "7":
        # seedpattern.hpp:29-223 (canonical periodic tables, no deviations).
        return _generate(
            "7",
            (1, 1, 1, 0, 1, 0, 0),
            min_read_len=23,
            min_seed_len=21,
            cared_size=80,
            nocared_lens=(60, 61, 62, 63, 64, 65, 66),
            exit1_seed=4,
        )
    raise ValueError(f"unknown seed pattern {name!r} (expected '3', '5' or '7')")
