"""Emulation of glibc ``rand()`` (TYPE_3 additive feedback generator).

The reference randomizes non-ACGT bases with ``rand() % 4``
(``src/walt/util.hpp:156-163``).  For reads the stream is reseeded with
``srand(0)`` at the start of every batch (``src/walt/mapping.cpp:73``), so
read N-randomization is deterministic and must be reproduced exactly for
bit-identical output.  (Genome N-randomization is seeded with
``time(NULL)`` in ``makedb.cpp:88`` and is not reproducible by design;
our indexer defaults to a fixed seed instead.)

glibc's default ``rand()`` is the TYPE_3 trinomial generator x[i] =
(x[i-3] + x[i-31]) mod 2**32, output x[i] >> 1, seeded by an LCG expansion
of the seed (seed 0 is treated as 1).  Verified against the C library in
tests/test_glibc_rand.py.
"""

from __future__ import annotations

import numpy as np


class GlibcRand:
    """Replays glibc rand() output for a given srand() seed."""

    def __init__(self, seed: int = 0):
        seed = seed & 0xFFFFFFFF
        if seed == 0:
            seed = 1
        if seed >= 2**31:  # glibc stores the seed in an int32_t
            seed -= 2**32
        # Initial LCG expansion: r[i] = 16807 * r[i-1] mod (2**31 - 1),
        # computed as in glibc on signed words with C (truncating) division.
        r = [0] * 344
        r[0] = seed & 0xFFFFFFFF
        word = seed
        for i in range(1, 31):
            # glibc: word = 16807*(word % 127773) - 2836*(word / 127773)
            hi = int(word / 127773) if word >= 0 else -(-word // 127773)
            lo = word - hi * 127773
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        for i in range(34, 344):
            r[i] = (r[i - 31] + r[i - 3]) & 0xFFFFFFFF
        self._r = r  # history; kept as a growing list with lazy trim
        self._i = 344

    def next(self) -> int:
        r, i = self._r, self._i
        v = (r[i - 31] + r[i - 3]) & 0xFFFFFFFF
        r.append(v)
        self._i += 1
        return v >> 1

    def take(self, n: int) -> np.ndarray:
        """Return the next n outputs as an int64 array."""
        out = np.empty(n, dtype=np.int64)
        for k in range(n):
            out[k] = self.next()
        return out

    def random_bases(self, n: int) -> np.ndarray:
        """Next n values of ``rand() % 4`` as uint8 codes (toACGT)."""
        out = np.empty(n, dtype=np.uint8)
        for k in range(n):
            out[k] = self.next() & 3
        return out
