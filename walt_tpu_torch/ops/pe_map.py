"""Paired-end mate step: both strand tables of one mate, flat-compacted.

Port of ``walt_tpu/ops/pe_map.py`` (``flat_from_wl``, ``map_mate_device``).
One call maps a mate's read chunk against its '+' and '-' tables with
``pipeline.map_strand_core(emit_wl=True)`` and packs the kept candidates
of both worklists into one flat stream:

- ``meta`` (B,) int32: per-read candidate counts for strand '+' (bits 0-7)
  and strand '-' (bits 8-15), and the fallback bit (16), set when either
  strand's pipeline flagged the read or its candidates spilled the flat
  capacity;
- ``flat`` (M, 2) int32 (u32 bits) with M = ``flat_factor`` * B: per
  candidate ``[genome_pos, (mm << 8) | (seed << 2) | (strand << 1)]``,
  read-major, strand '+' then '-' within a read, examination order within
  a strand -- the stream order of the bounded-heap replay
  (src/walt/paired.cpp:106-201, 684-692).

The counts in ``meta`` are the rows that landed in ``flat``.  Reads are
laid out read-major, so the reads that spill are a suffix of the chunk;
their counts are zero and their fallback bit is set, and the decoded
stream never reaches past M.  (walt_tpu counts the spilled rows too, and
its decoder then reads past the end of ``flat``.)  On a chunk that does
not spill, ``meta`` and ``flat`` are bit-equal to walt_tpu's.
"""

from __future__ import annotations

import torch

from walt_tpu_torch.ops import pipeline
from walt_tpu_torch.ops.packing import MASK32, to_i32
from walt_tpu_torch.ops.stages import PE_STEP_STAGE, strand_pass

#: PE tier-1 verify slab, worklist slots per read and flat slots per read
#: (the backend's ``pe_verify_slab``, ``pe_wl`` and ``pe_flat_factor``):
#: the JAX package's, chosen by tools/pe_tune.py on a TPU v5e
VERIFY_SLAB = 16
WL_FACTOR = 3
FLAT_FACTOR = 12


def flat_from_wl(wls, cnts, fb, flat_factor: int, cand_slab: int):
    """(meta (B,), flat (M, 2)) from the two strand worklists.

    ``wls``: [(wl_read, col, pos, mm, shift, keep)] for strand '+' then
    '-', the ``emit_wl`` outputs of ``pipeline.map_strand_core``;
    ``cnts``: the two (B,) capped per-read counts; ``fb``: (B,) bool.
    """
    B = cnts[0].shape[0]
    dev = cnts[0].device
    M = flat_factor * B
    c0, c1 = (c.to(torch.int64) for c in cnts)
    total = c0 + c1
    read_base = torch.cumsum(total, 0) - total
    spill = (read_base + total) > M
    # rows that do not land go to the spare row M, sliced off below
    flat = torch.zeros((M + 1, 2), dtype=torch.int32, device=dev)
    for s, (wlr, col, pos, mm, shift, keep) in enumerate(wls):
        dest = read_base[wlr] + (c0[wlr] if s else 0) + col
        dest = torch.where(keep & (col < cand_slab) & (dest < M), dest, M)
        word1 = ((((mm & MASK32) << 8) & MASK32)
                 | (torch.clamp(shift, min=0) << 2) | (s << 1))
        flat[dest, 0] = to_i32(pos)
        flat[dest, 1] = to_i32(word1)
    landed = ~spill
    meta = ((c0 * landed) | ((c1 * landed) << 8)
            | ((fb | spill).to(torch.int64) << 16))
    return meta.to(torch.int32), flat[:M]


def map_mate_device(preads, lens, b: int, max_mm: int, tables, *,
                    pattern_name: str, ag_wildcard: bool, search_bits: tuple,
                    verify_slab: int, cand_slab: int, wl_factor: float,
                    flat_factor: int, exact_b: bool = False,
                    uniq_bits: tuple = (0, 0), full_mask: bool = False,
                    stages=None):
    """One mate against both strand tables -> (meta (B,), flat (M, 2)).

    ``tables``: two device-table dicts, '+' first (the file order of
    paired.cpp:660-661); ``search_bits``/``uniq_bits``: one per table.
    The backend passes the PE shapes (:data:`VERIFY_SLAB`,
    :data:`WL_FACTOR`, :data:`FLAT_FACTOR`).  ``stages``: a recorder of
    ``ops/stages``: each strand pass is one of its passes (table index 0,
    1), then the flat compaction is marked ``flat``.
    """
    wls, cnts, fb = [], [], None
    for i, (t, bits, ubits) in enumerate(zip(tables, search_bits,
                                             uniq_bits)):
        with strand_pass(stages, i):
            wl, cnt, f = pipeline.map_strand_core(
                preads, lens, b, max_mm, t["pseq"], t["counter"], t["index"],
                t["key_words"], t["start_index"], t["bucket_flagged"],
                pattern_name=pattern_name, ag_wildcard=ag_wildcard,
                search_bits=bits, verify_slab=verify_slab,
                cand_slab=cand_slab, wl_factor=wl_factor, exact_b=exact_b,
                uniq_words=t.get("uniq_words"), uniq_off=t.get("uniq_off"),
                uniq_counter=t.get("uniq_counter"), uniq_bits=ubits,
                full_mask=full_mask, emit_wl=True, stages=stages,
            )
        wls.append(wl)
        cnts.append(cnt)
        fb = f if fb is None else (fb | f)
    out = flat_from_wl(wls, cnts, fb, flat_factor, cand_slab)
    if stages is not None:
        stages.mark(PE_STEP_STAGE, meta=out[0], flat=out[1])
    return out
