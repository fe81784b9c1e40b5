"""Vectorized single-end best-hit replay over device candidate slabs.

Copy of ``walt_tpu/host/replay_vec.py``: the NumPy spec of the device fold
(``ops/se_fold``).  Computes, for a whole batch at once, the same BestMatch
state the sequential fold in ``walt_tpu_torch.host.replay`` produces
(mapping.cpp:224-316 semantics, including the order-dependent ``times``
counting and seed early exits), using a NumPy fold over the six (strand,
seed) segments instead of a Python loop over reads.

Derivation (see replay.py for the scalar spec): within one (strand, seed)
segment only candidates whose mismatch count equals the segment-final best
affect the final state.  If the segment improves the best, ``times`` resets
at the first such candidate; otherwise the previously stored position is the
dedup anchor.  Either way ``times`` grows by the number of
adjacent-distinct transitions in the contributing-position subsequence
(anchor prepended), and the stored position/strand track the last
contributing candidate.  The seed early-exit gate (mapping.cpp:248-263) is
evaluated at each segment boundary against the running best.
"""

from __future__ import annotations

import numpy as np

from walt_tpu_torch.constants import SeedPattern

_BIG = np.int64(1 << 30)


def replay_single_batch(slabs, max_mismatches: int, pattern: SeedPattern):
    """Fold candidate slabs for both strand tables into BestMatch arrays.

    ``slabs``: list of (cand_seed (B,C) int8, cand_pos (B,C) uint32,
    cand_mm (B,C) int32) in file order ('+' table then '-' table).
    Returns (pos (B,) int64, times (B,) int64, strand_is_minus (B,) bool,
    mismatch (B,) int64).
    """
    B = slabs[0][0].shape[0]
    best = np.full(B, max_mismatches, dtype=np.int64)
    times = np.zeros(B, dtype=np.int64)
    stored = np.zeros(B, dtype=np.int64)  # BestMatch() starts at position 0
    minus = np.zeros(B, dtype=bool)

    for strand_idx, (cand_seed, cand_pos, cand_mm) in enumerate(slabs):
        C = cand_seed.shape[1]
        idx = np.arange(C)
        pos64 = cand_pos.astype(np.int64)
        mm64 = cand_mm.astype(np.int64)
        for seed in range(pattern.pattern_len):
            mask = cand_seed == seed
            if not mask.any():
                continue
            seg_mm = np.where(mask, mm64, _BIG)
            seg_min = seg_mm.min(axis=1)
            allowed = ~((best == 0) & (seed > 0)) & ~(
                (best == 1) & (seed >= pattern.exit1_seed)
            )
            improve = allowed & (seg_min < best)
            equal = allowed & (seg_min == best)
            active = improve | equal
            if not active.any():
                continue
            new_best = np.where(improve, seg_min, best)
            contrib = mask & (mm64 == new_best[:, None]) & active[:, None]

            cidx = np.where(contrib, idx, -1)
            last_before = np.maximum.accumulate(cidx, axis=1)
            prev_idx = np.empty_like(last_before)
            prev_idx[:, 0] = -1
            prev_idx[:, 1:] = last_before[:, :-1]
            anchor = np.where(improve, np.int64(-1), stored)
            prev_pos = np.where(
                prev_idx >= 0,
                np.take_along_axis(pos64, np.maximum(prev_idx, 0), axis=1),
                anchor[:, None],
            )
            trans = contrib & (pos64 != prev_pos)
            tdelta = trans.sum(axis=1)
            has = contrib.any(axis=1)
            last_idx = C - 1 - np.argmax(contrib[:, ::-1], axis=1)
            last_pos = np.take_along_axis(pos64, last_idx[:, None], axis=1)[:, 0]

            upd = active & has
            times = np.where(upd, np.where(improve, tdelta, times + tdelta), times)
            stored = np.where(upd, last_pos, stored)
            minus = np.where(active & (tdelta > 0), strand_idx == 1, minus)
            best = np.where(active, new_best, best)

    return stored, times, minus, best
