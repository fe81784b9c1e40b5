"""2-bit base packing and packed-word bit ops on torch tensors.

Port of ``walt_tpu/ops/packing.py``.  Bases are packed 16 per 32-bit word,
first base in the two MOST significant bits, so unsigned comparison of
words equals lexicographic comparison of bases and a left shift moves bases
toward lower positions.

Carrier convention.  Torch has no usable unsigned 32-bit dtype (shifts,
``~``, comparisons and ``+`` raise on ``torch.uint32``) and no popcount, so:

- resident arrays (packed genome, index, key words) are **int32 tensors
  holding the u32 bit patterns** (``np.ndarray.view(np.int32)``), which
  keeps device tables at their real size; kernels read them as
  ``uint32_t*``;
- arithmetic runs in **int64 on zero-extended values** (:func:`u32`);
  every left shift, ``~``, addition or subtraction that can carry past bit
  31 is masked back with :data:`MASK32`, reproducing the u32 wraparound
  the JAX code relies on.
"""

from __future__ import annotations

import numpy as np
import torch

#: lo bits of every 2-bit lane
LANE_LO = 0x55555555
MASK32 = 0xFFFFFFFF


def words_per_read(length: int) -> int:
    return (length + 15) // 16


def pack_codes_np(codes: np.ndarray) -> np.ndarray:
    """(…, L) uint8 codes (low 2 bits used) -> (…, ceil(L/16)) uint32,
    MSB-first.  Lane-strided accumulation: peak temporary is one lane
    (L/16 words), not a (…, W, 16) expansion -- this packs whole genomes."""
    L = codes.shape[-1]
    W = words_per_read(L)
    out = np.zeros(codes.shape[:-1] + (W,), dtype=np.uint32)
    for i in range(16):
        lane = codes[..., i::16]
        if lane.shape[-1] == 0:
            break
        lane = (lane & 3).astype(np.uint32)
        lane <<= np.uint32(30 - 2 * i)
        out[..., : lane.shape[-1]] |= lane
    return out


def clear_past_len_np(packed: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Zero, in place, the lanes of (B, W) packed read words at or past each
    read's length (a batch pads its code rows with PAD_CODE, whose low bits
    pack as G), and return them."""
    w = np.arange(packed.shape[-1], dtype=np.int64)[None, :]
    nvalid = np.clip(lens.astype(np.int64)[:, None] - 16 * w, 0, 16)
    keep = ((np.int64(1) << (2 * nvalid)) - 1) << (32 - 2 * nvalid)
    packed &= keep.astype(np.uint32)
    return packed


def pack_genome_np(seq_codes: np.ndarray, tail_words: int = 16) -> np.ndarray:
    """Genome codes -> packed words with ``tail_words`` zero words appended
    so window extraction never reads past the end."""
    packed = pack_codes_np(seq_codes[None, :])[0]
    return np.concatenate([packed, np.zeros(tail_words, dtype=np.uint32)])


def from_np(a: np.ndarray, device=None) -> torch.Tensor:
    """uint32 (or int32) numpy array -> int32 tensor with the same bits."""
    t = torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    return t if device is None else t.to(device)


def u32(t: torch.Tensor) -> torch.Tensor:
    """int32 tensor of u32 bit patterns -> int64 zero-extended values."""
    return t.to(torch.int64) & MASK32


def to_i32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same bits."""
    return (t - ((t >> 31) << 32)).to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR population count of int64 tensors holding 32-bit values."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def convert_ct(words: torch.Tensor) -> torch.Tensor:
    """C->T on packed int64 words (lane 01 -> 11)."""
    is_c = ((~words & MASK32) >> 1) & words & LANE_LO
    return words | (is_c << 1)


def convert_ga(words: torch.Tensor) -> torch.Tensor:
    """G->A on packed int64 words (lane 10 -> 00)."""
    is_g = (words >> 1) & (~words & MASK32) & LANE_LO
    return words & (~(is_g << 1) & MASK32)


def extract_lane(words: torch.Tensor, pos: int) -> torch.Tensor:
    """Base code at static position ``pos`` from (…, W) packed words."""
    return (words[..., pos // 16] >> (30 - 2 * (pos % 16))) & 3


def len_lane_masks(lens: torch.Tensor, n_words: int) -> torch.Tensor:
    """(B, W) int64 masks with the lo bit set for every lane < len."""
    w = torch.arange(n_words, dtype=torch.int64, device=lens.device)[None, :]
    nvalid = torch.clamp(lens.to(torch.int64)[:, None] - 16 * w, 0, 16)
    # a shift by 32 (nvalid == 0) lands wholly above bit 31 and masks to 0
    return (LANE_LO << (2 * (16 - nvalid))) & MASK32


def window_words(pseq: torch.Tensor, gpos: torch.Tensor,
                 n_words: int) -> torch.Tensor:
    """Packed windows of ``n_words`` words starting at base ``gpos``.

    pseq: (Wg,) int32 packed genome; gpos: int64 (…) start positions in
    [0, 2^32).  Returns (…, n_words) int64, base gpos+16*j first in word j.
    Word indices past the end clamp to the last word (JAX's ``mode="clip"``).
    """
    word0 = gpos >> 4
    sh = ((gpos & 15) << 1)[..., None]  # 0..30
    widx = word0[..., None] + torch.arange(
        n_words + 1, dtype=torch.int64, device=gpos.device
    )
    slices = u32(pseq[widx.clamp_(max=pseq.shape[0] - 1)])
    lo = slices[..., :n_words]
    hi = slices[..., 1:]
    # in int64, hi >> 32 is 0, so sh == 0 passes lo through unguarded
    return ((lo << sh) & MASK32) | (hi >> (32 - sh))
