"""The device mapping pipeline: seed -> refine -> verify -> compact.

Port of ``walt_tpu/ops/pipeline.py`` (``map_strand_core``, single device).
One call maps a fixed-shape read batch against one table:

1. seed hashing: the 12 cared bases per (read, shift) are extracted from the
   2-bit-packed read words and packed to a bucket key (util.hpp:175-182);
2. bucket refinement: a masked-prefix lower-bound binary search over packed
   key words (or over the word-0 RUNS of the uniq index) finds where the
   refined run starts (mapping.cpp:166-222);
3. the -b cap on the refined count (mapping.cpp:275-277) and chromosome
   boundary rejections (mapping.cpp:281-286);
4. verification on a cross-read worklist of refined survivors: the whole
   stage (chromosome bounds, the candidate verify, the pattern-typo
   corrections and the window cared check) is ``ops/verify.verify_worklist``,
   one fused kernel on a card;
5. ordered compaction of candidates with mismatch <= -m into a fixed slab,
   preserving (seed asc, bucket position asc) examination order -- or, with
   ``emit_wl``, the worklist itself with each kept row's slab column, for
   the paired-end flat emission (``ops/pe_map``).

A read whose run might extend past the slab, whose survivors spill the
worklist, or that touches a flagged bucket raises ``fallback`` and is
mapped by the exact host path.

Integer conventions follow ``ops/packing``: resident tensors are int32 u32
bit patterns; everything here computes in int64, masking back to 32 bits
where the JAX code relies on u32 wraparound.  JAX's clamped gathers
(``mode="clip"``) are explicit clamps, and its dropped scatters
(``mode="drop"``) scatter into one spare slot that is sliced off.

With ``key_base`` the table is one tp shard of a bucket-range split
(``walt_tpu_torch.parallel.sharded``): keys outside the shard's buckets
yield empty regions, and with ``tp_route`` the (read, seed) pairs the shard
owns are compacted first, so everything from the search down runs at about
1/T of the unsharded size.

``stages`` takes the place of walt_tpu's ``stage_out`` profiling hook (the
truncated-program checksums): a recorder of ``ops/stages`` that the pass
marks at each stage boundary (keys, search, membership, worklist, verify,
compact) with the tensors alive there; its CUDA timer gives each stage's
stream time and, under ``torch.profiler``, its device busy time and
launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from walt_tpu_torch.constants import get_pattern
from walt_tpu_torch.ops import packing, verify
from walt_tpu_torch.ops.packing import MASK32, u32
from walt_tpu_torch.ops.stages import marker

#: tier-1 verify slab: refined entries verified per (read, seed)
VERIFY_SLAB_T1 = 8
#: tier-2 verify slab for reads that overflowed tier 1
VERIFY_SLAB = 64
#: max surviving candidates per (read, strand)
CAND_SLAB = 32
#: worklist slots per read in a chunk; spills take the host path
WL_FACTOR = 4
#: SE tier-1 worklist slots per read (the backend's start for ``_wl1``,
#: walt_tpu's: survivors average ~1.2 per read on its TPU v5e profile)
WL1 = 1.5

#: per-device CSR entry-count ceiling: entry INDICES are < 2^31 (int32 in
#: the resident tables); genome POSITIONS are u32 (4 Gbp format limit)
ENTRY_LIMIT = 1 << 31


def check_entry_limit(n_entries: int, where: str) -> None:
    """Raise before a device-local table overflows its int32 indices."""
    if n_entries >= ENTRY_LIMIT:
        raise ValueError(
            f"{where}: {n_entries} entries >= 2^31 would overflow the "
            f"pipeline's int32 entry indices; shard the table (tp) so each "
            f"device-local CSR stays below {ENTRY_LIMIT} entries"
        )


def _lex_ge(es, rs):
    """Lexicographic (entry >= read) on N masked word pairs."""
    ge = es[-1] >= rs[-1]
    for e, r in zip(reversed(es[:-1]), reversed(rs[:-1])):
        ge = (e > r) | ((e == r) & ge)
    return ge


def _binary_lower(l, r, probe, bits: int):
    """First index in [l, r) where monotone ``probe`` holds (lower bound).

    ``walt_tpu``'s ``_kary_lower`` at k = 2 (the arity it measured best).
    ``bits`` bounds the interval length by 2^bits - 1; each of the ``bits``
    rounds halves every active interval with ``l + (r - l) // 2``, which
    cannot overflow.
    """
    for _ in range(max(1, bits)):
        active = l < r
        m = l + (r - l) // 2
        ge = probe(m)
        new_l = torch.where(ge, l, m + 1)
        new_r = torch.where(ge, m, r)
        l = torch.where(active, new_l, l)
        r = torch.where(active, new_r, r)
    return l


def _take(t, idx):
    """Gather with indices clamped into range (JAX's ``mode="clip"``)."""
    return t[idx.clamp(0, t.shape[0] - 1)]


def window_cared_mask(pattern, seeds, W: int, key16: bool) -> np.ndarray:
    """(S, W) int64 lane masks of the cared positions the window cared check
    enforces: cared[kw + 16 .. n_cared) (key16: from kw + 8) shifted by each
    seed, inside the W-word window.  The stage ANDs the XOR-fold with
    them and a per-row cutoff at cared[seed_len], which needs the cared
    table to be periodic-affine (cared[j] = (j // cw) * plen + cared[j % cw])."""
    kw, cared, plen = pattern.key_weight, pattern.cared, pattern.pattern_len
    n_cared = min(pattern.cared_size, kw + 48)
    check_from = kw + 8 if key16 else kw + 16
    out = np.zeros((len(seeds), W), dtype=np.int64)
    for si_, s in enumerate(seeds):
        for jj in range(check_from, n_cared):
            p = int(cared[jj]) + s
            if p < W * 16:
                out[si_, p // 16] |= 1 << (30 - 2 * (p % 16))
    cwt = pattern.cared_weight
    if not all(int(cared[j]) == (j // cwt) * plen + int(cared[j % cwt])
               for j in range(n_cared)):
        raise ValueError("cared table is not periodic-affine; "
                         "the exact_b path is required")
    return out


@functools.lru_cache(maxsize=256)
def _pass_consts(device, pattern_name: str, seeds: tuple, W: int) -> dict:
    """The strand pass's constant tables on ``device``, made once per
    (device, pattern, seeds, W) and not inside the pass: a pass captured
    into a CUDA graph (``ops/graphs``) must not copy from host memory.

    ``word_tab`` / ``shift_tab`` / ``in_range_tab``: where cared position p
    of seed shift s (``cared[p] + s``) lies in the packed read words (word
    index, in-word shift, inside the read's W words), (S, n_cared) and
    broadcastable over the reads; ``pack_shifts[k]``: the left shifts that
    pack k 2-bit codes into one word; ``shifts``: the seed shifts."""
    pattern = get_pattern(pattern_name)
    n_cared = min(pattern.cared_size, pattern.key_weight + 48)
    pos_tab = np.asarray(
        [[int(pattern.cared[p]) + s for p in range(n_cared)] for s in seeds]
    )  # (S, n_cared)
    in_range = pos_tab < W * 16

    def const(a, dtype=torch.int64):
        return torch.from_numpy(np.asarray(a)).to(dtype=dtype, device=device)

    return dict(
        word_tab=const(np.where(in_range, pos_tab // 16, 0)),
        shift_tab=const(30 - 2 * (pos_tab % 16))[None],
        in_range_tab=const(in_range, torch.bool)[None],
        pack_shifts={k: const(np.arange(k - 1, -1, -1) * 2)
                     for k in range(1, 17)},
        shifts=const(seeds))


def map_strand_core(preads, lens, b: int, max_mm: int, pseq, counter, index,
                    key_words, start_index, bucket_flagged, *,
                    pattern_name: str, ag_wildcard: bool, search_bits: int,
                    verify_slab: int = VERIFY_SLAB_T1,
                    cand_slab: int = CAND_SLAB, seeds: tuple | None = None,
                    wl_factor: float = WL_FACTOR, exact_b: bool = False,
                    uniq_words=None, uniq_off=None, uniq_counter=None,
                    uniq_bits: int = 0, full_mask: bool = False,
                    key_base: int | None = None, tp_route: int = 0,
                    emit_wl: bool = False, stages=None):
    """Map a read batch against one table.

    preads: (B, W) int32 packed read codes (u32 bits); lens: (B,) int32;
    the table tensors as :func:`walt_tpu_torch.ops.device_index.place_table`
    and the device builders make them.  Returns (cand_seed (B, C) int8,
    cand_pos (B, C) int64 u32 values, cand_mm (B, C) int32, cand_cnt (B,)
    int32, fallback (B,) bool) with C = ``cand_slab``.

    ``exact_b``: False (valid whenever ``b >= verify_slab``) probes only the
    first packed key word and enforces the remaining cared positions from
    the verify window; True probes all words lexicographically so the
    refined COUNT is exact within the slab (needed when ``b`` is smaller).

    ``uniq_*``: the word-0 run index (``build_uniq_device``); with
    ``uniq_bits > 0`` and not ``exact_b`` the search runs in run space and
    slab admission is arithmetic on the run bounds.  ``key_words`` may then
    be a dummy.  A 1-D int16 ``key_words`` holds key16 prefixes.

    ``full_mask``: promise that every real read compares a full first key
    word (seed_len >= key_weight + 16), so the refined run is one word-0 run
    and needs no upper-bound probe chain.

    ``key_base``: the table is one tp shard whose ``counter`` spans buckets
    [key_base, key_base + len(counter) - 1); keys outside it yield empty
    regions.  ``tp_route`` (needs ``key_base``): the tp size T.  With T > 1
    the shard's owned (read, seed) pairs are compacted, order-preserving,
    into K = min(B*S, int(1.25*B*S/T) + 128) rows before the search, and the
    worklist shrinks to ``int(wl_factor*B/T)`` rows; reads whose owned pairs
    spill K fall back, like worklist spills.

    ``emit_wl``: skip the slab compaction and return the worklist stream
    ``((wl_read, col, pos, mm, shift, keep), cand_cnt, fallback)``: (M,)
    int64 rows (``keep`` bool), where ``col`` is a kept row's rank among
    its read's kept rows (its slab column; ``cand_slab`` on dropped rows).

    ``stages``: a recorder of ``ops/stages`` (None: nothing is recorded);
    the pass calls its ``mark`` after each of ``stages.STRAND_STAGES``.
    """
    mark = marker(stages)
    pattern = get_pattern(pattern_name)
    plen = pattern.pattern_len
    seeds = tuple(range(plen)) if seeds is None else tuple(seeds)
    S = len(seeds)
    kw = pattern.key_weight
    cared = pattern.cared
    B, W = preads.shape
    Lmax = W * 16
    n_entries = index.shape[0]
    C = verify_slab
    dev = preads.device
    consts = _pass_consts(dev, pattern_name, seeds, W)

    # --- read conversion (mapping.cpp:142-164) on packed words ---
    words = u32(preads)
    conv = packing.convert_ga(words) if ag_wildcard else packing.convert_ct(words)

    lens = lens.to(torch.int64)
    read_ok = lens >= pattern.min_read_len  # (B,)
    repeats = torch.clamp((lens - plen + 1) // plen, max=pattern.max_repeats())
    seed_len = torch.clamp(repeats * pattern.cared_weight,
                           max=pattern.cared_size)

    # cared-base extraction over static position tables (_pass_consts)
    n_cared = min(pattern.cared_size, kw + 48)
    cvals = (conv[:, consts["word_tab"]] >> consts["shift_tab"]) & 3
    cvals = torch.where(consts["in_range_tab"], cvals, 0)  # (B, S, n_cared)

    def pack16(vals):
        """(…, k<=16) 2-bit codes -> one 32-bit value, first most significant."""
        return (vals << consts["pack_shifts"][vals.shape[-1]]).sum(-1)

    # --- seed hash keys: (B, S) ---
    key = pack16(cvals[..., :kw])

    use_uniq = uniq_bits > 0 and not exact_b and uniq_words is not None
    # bucket_flagged bits: bit0 = host path in the fast mode, bit1 = host
    # path in the exact_b mode.  On the uniq path lo/hi are RUN-space bounds
    bounds = uniq_counter if use_uniq else counter
    fbit = 2 if exact_b else 1
    route = tp_route > 1 and key_base is not None
    if key_base is None:
        lo = bounds[key].to(torch.int64)  # (B, S)
        hi = bounds[key + 1].to(torch.int64)
        flagged = (bucket_flagged[key] & fbit) != 0
    else:
        # u32 wrap: a key below the shard's base becomes large, not negative
        local = (key - key_base) & MASK32
        in_range = local < bounds.shape[0] - 1
        lidx = torch.where(in_range, local, 0)
        flagged = in_range & ((bucket_flagged[lidx] & fbit) != 0)
        if not route:
            lo = torch.where(in_range, bounds[lidx].to(torch.int64), 0)
            hi = torch.where(in_range, bounds[lidx + 1].to(torch.int64), 0)

    # --- read prefix key words (cared[kw..kw+47] per shift) + masks; reads
    # of W words cannot need deeper words than seed_len_for_len(W*16)
    max_seed_len = min(int(pattern.seed_len_for_len(Lmax)), kw + 48)
    npw = max(1, min(3, -(-(max_seed_len - kw) // 16)))
    rwords = []
    for w in range(npw):
        a, z = kw + w * 16, min(kw + w * 16 + 16, n_cared)
        if a >= z:
            rwords.append(torch.zeros((B, S), dtype=torch.int64, device=dev))
            continue
        rwords.append((pack16(cvals[..., a:z]) << (2 * (16 - (z - a))))
                      & MASK32)
    masks = []
    for w in range(npw):
        nbits = torch.clamp(seed_len[:, None] - kw - 16 * w, 0, 16) * 2
        shift = torch.clamp(32 - nbits, 0, 31)
        m = torch.where(nbits > 0, (MASK32 << shift) & MASK32, 0)
        masks.append(m.expand(B, S))
    rws = [rw & m for rw, m in zip(rwords, masks)]

    if route:
        # --- compact this shard's OWNED (read, seed) pairs into K rows.  The
        # flat pair order is read-major then seed asc, so examination order
        # is kept; everything below runs in the row space (K,) instead of
        # (B, S)
        pairs = B * S
        K = min(pairs, int(1.25 * pairs / tp_route) + 128)
        own_flat = in_range.reshape(pairs)
        gq = torch.cumsum(own_flat, 0) - 1
        r_src = torch.full((K + 1,), -1, dtype=torch.int64, device=dev)
        r_src[torch.where(own_flat & (gq < K), gq, K)] = torch.arange(
            pairs, dtype=torch.int64, device=dev)
        r_src = r_src[:K]
        # reads whose owned pairs spilled the route capacity -> host path
        route_spill = (own_flat & (gq >= K)).reshape(B, S).any(1)
        rvalid = r_src >= 0
        r_flat = torch.clamp(r_src, min=0)
        r_read = r_flat // S
        r_seedi = r_flat % S

        def rgat(x):  # (B, S) -> (K,)
            return x.reshape(-1)[r_flat]

        lidx_r = rgat(lidx)
        lo = torch.where(rvalid, bounds[lidx_r].to(torch.int64), 0)
        hi = torch.where(rvalid, bounds[lidx_r + 1].to(torch.int64), 0)
        flagged_r = rgat(flagged) & rvalid
        masks = [rgat(m) for m in masks]
        rws = [rgat(w) for w in rws]

        def by_read(v):  # (K,) bool -> (B,) any
            return torch.zeros(B, dtype=torch.int64, device=dev).index_add_(
                0, r_read, (v & rvalid).to(torch.int64)) > 0

    mark("keys", lo=lo, hi=hi, flagged=flagged,
         in_range=None if key_base is None else in_range)

    # key words probed by the search and slab admission; the fast path
    # defers words beyond the first to the window cared check
    nprobe = npw if exact_b else 1
    run_len = None
    key16 = (not use_uniq) and key_words.dim() == 1 \
        and key_words.dtype == torch.int16
    if key16 and exact_b:
        raise ValueError("exact_b path needs full key words, not key16")
    if not use_uniq and not key16:
        if key_words.dim() == 1:
            key_words = key_words[:, None]
        if key_words.shape[1] < nprobe:
            raise ValueError(
                f"device table stores {key_words.shape[1]} key word(s) but "
                f"the exact_b={exact_b} path probes {nprobe}; rebuild the "
                f"table with n_key_words={nprobe}"
            )

        def kword(w, idx):
            return u32(key_words[idx.clamp(0, n_entries - 1), w])

        def probe(mid):
            es = [kword(w, mid) & m for w, m in zip(range(nprobe), masks)]
            return _lex_ge(es, rws[:nprobe])

        lower = _binary_lower(lo, hi, probe, search_bits)
    elif key16:
        m16 = masks[0] >> 16
        rw16 = rws[0] >> 16  # rws already masked

        def k16(idx):
            return _take(key_words, idx).to(torch.int64) & 0xFFFF

        lower = _binary_lower(lo, hi, lambda m: (k16(m) & m16) >= rw16,
                              search_bits)
    else:
        # run-space refinement: the lower bound over uniq_words needs
        # uniq_bits probes, and the run bounds then give the refined region
        # in entry space with uniq_off gathers
        m0, rw0 = masks[0], rws[0]

        def uword(idx):
            return u32(_take(uniq_words, idx)) & m0

        lu = _binary_lower(lo, hi, lambda m: uword(m) >= rw0, uniq_bits)
        elo = _take(uniq_off, lu).to(torch.int64)
        if full_mask:
            # every real read compares a full word 0: the refined region is
            # exactly one run, present iff uniq_words[lu] equals it
            hit = (lu < hi) & (uword(lu) == rw0)
            ehi = torch.where(hit, _take(uniq_off, lu + 1).to(torch.int64),
                              elo)
        else:
            # masked (short-read) prefixes can span several runs: a second
            # probe chain finds the first run past the prefix group
            l2 = _binary_lower(lu, hi, lambda m: uword(m) > rw0, uniq_bits)
            ehi = _take(uniq_off, l2).to(torch.int64)
        lower = elo
        run_len = torch.clamp(ehi - elo, min=0)
    mark("search", lower=lower, run_len=run_len)

    # --- slab membership: an entry is in the reference's refined range iff
    # its masked key words EQUAL the read's masked prefix words
    shifts = consts["shifts"]  # (S,)
    # row space: (B, S) unrouted, (K,) routed; jC broadcasts the slab axis
    jC = torch.arange(C, dtype=torch.int64, device=dev)
    jC = jC[None, :] if route else jC[None, None, :]
    if use_uniq:
        # run bounds are exact: slab admission is pure arithmetic
        refined_cnt = torch.clamp(run_len, max=C)
        refined = jC < refined_cnt[..., None]
        capped = refined_cnt > b  # never fires in the fast path (b >= slab)
        overflow = (run_len > C) & ~capped
    else:
        refined = jC < (hi - lower)[..., None]
        slotc = torch.clamp(lower[..., None] + jC, 0, n_entries - 1)
        if key16:
            es = (key_words[slotc].to(torch.int64) & 0xFFFF) & m16[..., None]
            refined = refined & (es == rw16[..., None])
        else:
            for w, m, rw in zip(range(nprobe), masks, rws):
                es = u32(key_words[slotc, w]) & m[..., None]
                refined = refined & (es == rw[..., None])
        refined_cnt = refined.sum(-1)
        # seed skipped entirely (mapping.cpp:275-277)
        capped = refined_cnt > b
        # run may extend past the slab: every examined slot matched and
        # bucket entries remain beyond it; a capped seed is already exact
        examined = torch.clamp(hi - lower, 0, C)
        overflow = (refined_cnt == examined) & ((hi - lower) > C) & ~capped

    row_ok = read_ok[r_read] if route else read_ok[:, None]
    keep_pre = (refined & ~capped[..., None] & ~overflow[..., None]
                & row_ok[..., None])
    mark("membership", refined_cnt=refined_cnt, overflow=overflow,
         keep_pre=keep_pre)

    # --- compact the refined survivors into one flat cross-read worklist in
    # (read, seed asc, bucket position asc) order = examination order; a
    # routed shard carries ~1/T of the survivors, so its worklist shrinks by
    # T (the float arithmetic is walt_tpu's, so M is the same)
    M = max(1, int(wl_factor * B / (tp_route if route else 1)))
    n_rows = K if route else B * S
    n_flat = n_rows * C
    keep_flat = keep_pre.reshape(n_flat)
    gidx = torch.cumsum(keep_flat, 0) - 1
    wl_src = torch.full((M + 1,), -1, dtype=torch.int64, device=dev)
    wl_src[torch.where(keep_flat & (gidx < M), gidx, M)] = torch.arange(
        n_flat, dtype=torch.int64, device=dev)
    wl_src = wl_src[:M]
    # reads whose survivors spilled past the worklist take the host path
    spilled = (keep_flat & (gidx >= M)).reshape(n_rows, C).any(1)
    wl_spill = by_read(spilled) if route else spilled.reshape(B, S).any(1)

    wl_valid = wl_src >= 0
    wl_flat = torch.clamp(wl_src, min=0)
    wl_bs = wl_flat // C
    if route:
        wl_read = r_read[wl_bs]
        wl_seedi = r_seedi[wl_bs]
    else:
        wl_read = wl_flat // (S * C)
        wl_seedi = wl_bs % S
    wl_entryidx = lower.reshape(-1)[wl_bs] + wl_flat % C
    wl_shift = shifts[wl_seedi]  # (M,)

    cared_np = None
    if not exact_b and (npw > 1 or key16):
        # Window cared check: a fast-path row is only known to match the
        # read on the hash key + the first key word (or its 16-bit prefix);
        # the refined region also requires equality at cared positions
        # kw+16 (key16: kw+8) .. seed_len-1 (mapping.cpp:198-222).  Those
        # bases sit inside the verify window, checked there.
        cared_np = window_cared_mask(pattern, seeds, W, key16)
    mark("worklist", wl_src=wl_src, wl_entryidx=wl_entryidx,
         wl_spill=wl_spill)

    # --- the verify stage, one fused kernel on a card (ops/verify): index
    # gather, chromosome bounds (mapping.cpp:282-286), the verify kernel,
    # the verify_skip corrections, mm <= -m and the window cared check
    wl_gpos, mm, wl_keep = verify.verify_worklist(
        wl_read, wl_seedi, wl_entryidx, wl_valid, conv, lens, repeats,
        index, pseq, start_index, seeds=seeds,
        verify_skip=pattern.verify_skip, cared_mask=cared_np,
        cared_off=cared[:pattern.cared_weight], max_mm=max_mm, plen=plen,
        cwt=pattern.cared_weight, n_cared=n_cared,
    )
    mark("verify", wl_gpos=wl_gpos, mm=mm, wl_keep=wl_keep)

    # --- ordered compaction into the per-read candidate slab ---
    keep64 = wl_keep.to(torch.int64)
    cnt = torch.zeros(B, dtype=torch.int64, device=dev).index_add_(
        0, wl_read, keep64)
    base = torch.cumsum(cnt, 0) - cnt  # kept entries before each read
    rank = torch.cumsum(keep64, 0) - 1
    col = torch.where(wl_keep, rank - base[wl_read], cand_slab)

    if route:
        # flagged buckets: stored order / padding quirks make the refined
        # run irreproducible on device -> exact host path
        device_fb = by_read(overflow) | by_read(flagged_r & (hi > lo))
    else:
        device_fb = overflow.any(1) | (flagged & (hi > lo)).any(1)
    fallback = (
        device_fb & read_ok
        # packed key words cover cared positions kw..kw+47 only
        | (seed_len > kw + 48)
        | (cnt > cand_slab)
        | wl_spill
    )
    if route:
        fallback = fallback | route_spill
    cand_cnt = torch.clamp(cnt, max=cand_slab).to(torch.int32)
    if emit_wl:
        wl = (wl_read, col, wl_gpos, mm, wl_shift, wl_keep)
        mark("compact", wl=wl, cand_cnt=cand_cnt, fallback=fallback)
        return wl, cand_cnt, fallback

    # dropped rows and ranks past the slab land in the spare column
    dest = torch.clamp(col, max=cand_slab)

    def compact(vals, fill, dtype):
        out = torch.full((B, cand_slab + 1), fill, dtype=dtype, device=dev)
        out[wl_read, dest] = vals.to(dtype)
        return out[:, :cand_slab]

    cand_seed = compact(wl_shift, -1, torch.int8)
    cand_pos = compact(wl_gpos, 0, torch.int64)
    cand_mm = compact(mm, 0, torch.int32)
    mark("compact", cand_seed=cand_seed, cand_pos=cand_pos, cand_mm=cand_mm,
         cand_cnt=cand_cnt, fallback=fallback)
    return cand_seed, cand_pos, cand_mm, cand_cnt, fallback
