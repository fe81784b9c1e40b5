"""Device-side single-end best-hit fold + the fused SE mapping step.

Port of ``walt_tpu/ops/se_fold.py`` (single device).  Folds the candidate
slabs of both strand tables into per-read BestMatch state on the device, so
a chunk costs one small ((B, 3)) device-to-host copy instead of the slabs.

The fold is the torch form of ``walt_tpu_torch.host.replay_vec`` (the
vectorized BestMatch state machine, mapping.cpp:224-316, with the seed
early-exit gates of mapping.cpp:248-263): identical ``times`` /
stored-position / strand semantics.  :func:`combine_summaries` joins the summaries of the tp shards
of one table (``walt_tpu_torch.parallel.sharded``).
"""

from __future__ import annotations

import numpy as np
import torch

from walt_tpu_torch.constants import get_pattern
from walt_tpu_torch.ops import pipeline
from walt_tpu_torch.ops.stages import SE_STEP_STAGE, strand_pass

#: "no candidates in this segment" mismatch sentinel
_BIG = 1 << 30


def _shift_right(x, d: int):
    """Shift the last axis right by ``d`` slots, filling with zeros."""
    pad = torch.zeros(x.shape[:-1] + (d,), dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., : x.shape[-1] - d]], dim=-1)


def segment_summaries(cand_seed, cand_pos, cand_mm, pattern):
    """Per-(read, seed) fold summaries of one strand's candidate slab.

    Whenever a (strand, seed) segment is active in the fold, its new best is
    the segment minimum, so everything the fold needs per segment is five
    (B, S) tensors: ``seg_min`` (_BIG when empty), ``inner_t`` (adjacent
    distinct-position transitions among the min-achieving contributors),
    ``first_pos`` / ``last_pos`` (first / last contributor position) and
    ``has`` (any contributor).
    """
    B, C = cand_seed.shape
    S = pattern.pattern_len
    dev = cand_seed.device
    pos = cand_pos.to(torch.int64)[:, None, :]
    mm = cand_mm.to(torch.int64)[:, None, :]
    mask = cand_seed.to(torch.int64)[:, None, :] == torch.arange(
        S, dtype=torch.int64, device=dev)[None, :, None]  # (B, S, C)
    seg_min = torch.where(mask, mm, _BIG).amin(2)  # (B, S)
    contrib = mask & (mm == seg_min[:, :, None])

    # last contributing position at-or-before each slot, by log-shift
    # propagation over the slab axis
    v = torch.where(contrib, pos, 0)
    h = contrib
    d = 1
    while d < C:
        v = torch.where(h, v, _shift_right(v, d))
        h = h | _shift_right(h, d)
        d *= 2
    prev_has = _shift_right(h, 1)
    prev_pos = _shift_right(v, 1)
    inner_t = (contrib & prev_has & (pos != prev_pos)).sum(2)
    first = contrib & ~prev_has  # at most one slot per segment
    first_pos = torch.where(first, pos, 0).sum(2)
    return dict(seg_min=seg_min, inner_t=inner_t, first_pos=first_pos,
                last_pos=v[:, :, -1], has=h[:, :, -1])


def combine_summaries(parts):
    """Join the summaries of one table's tp shards.

    A bucket lives wholly on one shard, so at most one shard has
    contributors for a (read, seed): the first shard with ``has`` wins, and
    ``seg_min`` is min-combined for safety (walt_tpu's rule).
    """
    out = dict(parts[0])
    for p in parts[1:]:
        take = ~out["has"] & p["has"]
        out["seg_min"] = torch.minimum(out["seg_min"], p["seg_min"])
        for k in ("inner_t", "first_pos", "last_pos"):
            out[k] = torch.where(take, p[k], out[k])
        out["has"] = out["has"] | p["has"]
    return out


def fold_summaries(summaries, max_mm: int, pattern):
    """BestMatch fold over per-strand segment summaries ('+' then '-').

    Exact port of the sequential state machine: the anchor comparison
    (first contributor vs the stored position, or vs a fresh sentinel after
    an improvement) is re-added here.
    """
    B = summaries[0]["seg_min"].shape[0]
    dev = summaries[0]["seg_min"].device
    best = torch.full((B,), int(max_mm), dtype=torch.int64, device=dev)
    times = torch.zeros(B, dtype=torch.int64, device=dev)
    stored = torch.zeros(B, dtype=torch.int64, device=dev)  # BestMatch() at 0
    minus = torch.zeros(B, dtype=torch.bool, device=dev)

    for strand_idx, s in enumerate(summaries):
        for seed in range(pattern.pattern_len):
            seg_min = s["seg_min"][:, seed]
            has = s["has"][:, seed]
            allowed = ~((best == 0) & (seed > 0)) & ~(
                (best == 1) & (seed >= pattern.exit1_seed)
            )
            improve = allowed & (seg_min < best)
            active = improve | (allowed & (seg_min == best))
            # the first contributor counts as a transition unless it equals
            # the stored position (never after an improvement)
            anchor_ne = improve | (s["first_pos"][:, seed] != stored)
            tdelta = torch.where(
                has, s["inner_t"][:, seed] + anchor_ne.to(torch.int64), 0
            )
            upd = active & has
            times = torch.where(
                upd, torch.where(improve, tdelta, times + tdelta), times
            )
            stored = torch.where(upd, s["last_pos"][:, seed], stored)
            minus = torch.where(active & (tdelta > 0), strand_idx == 1, minus)
            best = torch.where(active, torch.minimum(seg_min, best), best)

    return stored, times, minus, best


def se_fold(slabs, max_mm: int, pattern):
    """Fold [(cand_seed, cand_pos, cand_mm)] ('+' then '-') to BestMatch.

    Returns (pos (B,) int64, times (B,) int64, minus (B,) bool,
    mismatch (B,) int64).
    """
    return fold_summaries(
        [segment_summaries(cs, cp, cm, pattern) for cs, cp, cm in slabs],
        max_mm, pattern,
    )


def map_single_end_device(preads, lens, b: int, max_mm: int, tables, *,
                          pattern_name: str, ag_wildcard: bool,
                          search_bits: tuple,
                          verify_slab: int = pipeline.VERIFY_SLAB,
                          cand_slab: int = pipeline.CAND_SLAB,
                          seeds: tuple | None = None,
                          wl_factor: float = pipeline.WL_FACTOR,
                          exact_b: bool = False,
                          uniq_bits: tuple = (0, 0),
                          full_mask: bool = False, stages=None):
    """Full SE mapping step: both strand tables -> per-read BestMatch.

    ``tables``: two dicts of resident tensors ('+' table first,
    mapping.cpp:491-499 file order).  Returns one (B, 3) int64 tensor --
    [pos, times, (mm << 2) | (minus << 1) | fallback] -- so a chunk's
    result is one copy; unpack with :func:`unpack_se_result`.
    ``stages``: a recorder of ``ops/stages``: each strand pass is one of
    its passes (table index 0, 1), then the fold is marked ``fold``.
    """
    pattern = get_pattern(pattern_name)
    slabs = []
    fallback = None
    for i, (t, bits, ubits) in enumerate(zip(tables, search_bits,
                                             uniq_bits)):
        with strand_pass(stages, i):
            cs, cp, cm, _, fb = pipeline.map_strand_core(
                preads, lens, b, max_mm, t["pseq"], t["counter"], t["index"],
                t["key_words"], t["start_index"], t["bucket_flagged"],
                pattern_name=pattern_name, ag_wildcard=ag_wildcard,
                search_bits=bits, verify_slab=verify_slab,
                cand_slab=cand_slab, seeds=seeds, wl_factor=wl_factor,
                exact_b=exact_b, uniq_words=t.get("uniq_words"),
                uniq_off=t.get("uniq_off"),
                uniq_counter=t.get("uniq_counter"), uniq_bits=ubits,
                full_mask=full_mask, stages=stages,
            )
        slabs.append((cs, cp, cm))
        fallback = fb if fallback is None else (fallback | fb)
    out = pack_se_result(*se_fold(slabs, max_mm, pattern), fallback)
    if stages is not None:
        stages.mark(SE_STEP_STAGE, packed=out)
    return out


def pack_se_result(pos, times, minus, mm, fallback):
    """One (B, 3) int64 tensor [pos, times, (mm << 2) | (minus << 1) |
    fallback] from the fold's outputs and the fallback mask."""
    flags = (mm << 2) | (minus.to(torch.int64) << 1) | fallback.to(torch.int64)
    return torch.stack([pos, times, flags], dim=1)


def unpack_se_result(packed: np.ndarray):
    """(B, 3) int64 -> (pos u32, times i32, minus bool, mm i32, fb bool)."""
    flags = packed[:, 2]
    return (packed[:, 0].astype(np.uint32), packed[:, 1].astype(np.int32),
            (flags & 2).astype(bool), (flags >> 2).astype(np.int32),
            (flags & 1).astype(bool))
