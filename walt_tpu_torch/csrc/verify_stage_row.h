// Per-row body of the fused verify-stage kernel (csrc/verify_stage.cu).
//
// Kept in a header with no CUDA-only code outside __CUDA_ARCH__ blocks so
// that g++ can build the same arithmetic for a ctypes test on a machine
// without a GPU (tests/test_torch_verify.py).  The plain PyTorch version is
// walt_tpu_torch/ops/verify.py::verify_worklist_reference.
#pragma once

#include <stdint.h>

#include "verify_row.h"

#if defined(__CUDA_ARCH__)
#define WALTX_LDG(p) __ldg(p)
#else
#define WALTX_LDG(p) (*(p))
#endif

namespace waltx {

constexpr int kStageMaxSeeds = 8;   // seed shifts per pattern (pattern_len <= 7)
constexpr int kStageMaxSkips = 8;   // verify_skip triples
constexpr int kStageMaxCwt = 16;    // cared_weight
constexpr int kStageMaxW = 64;      // words per read (MAX_LINE_LENGTH 1000 bp)

// Everything one launch needs, passed by value as the kernel's parameter
// (so the stage makes no host-to-device copy of its small constants).
// The layout is mirrored by ctypes in walt_tpu_torch/ops/verify.py: fixed
// width fields, pointers first, no implicit padding.
struct StageArgs {
  // per-row inputs (M,)
  const int64_t* wl_read;
  const int64_t* wl_seedi;
  const int64_t* wl_entryidx;
  const uint8_t* wl_valid;  // torch.bool
  // per-read inputs: conv (B, W) u32 values in int64, lens (B,), repeats (B,)
  const int64_t* conv;
  const int64_t* lens;
  const int64_t* repeats;
  // tables: u32 bits in int32 storage
  const uint32_t* index;
  const uint32_t* pseq;
  const uint32_t* start_index;
  // outputs (M,): window start (u32 value), mismatches, keep
  int64_t* gpos;
  int64_t* mm;
  uint8_t* keep;  // torch.bool
  int64_t M, B, n_index, n_pseq;
  int32_t n_si;      // start_index entries (n_chroms + 1)
  int32_t W;         // words per read
  int32_t S;         // seed shifts
  int32_t n_skip;    // verify_skip triples with posn < 16 * W
  int32_t max_mm, plen, cwt, n_cared;
  int32_t check;     // the window cared check runs
  int32_t conv_smem_bytes;  // capacity of the staged conv range (kernel)
  int32_t si_smem;   // start_index is staged in shared memory (kernel)
  int32_t pad0;
  int32_t shifts[kStageMaxSeeds];
  int32_t skip_shift[kStageMaxSkips];
  int32_t skip_min_rep[kStageMaxSkips];
  int32_t skip_posn[kStageMaxSkips];
  int32_t cared_off[kStageMaxCwt];              // cared[:cwt]
  uint32_t cared_mask[kStageMaxSeeds * kStageMaxW];  // (S, W) lane masks
};

// Lo bit of every 2-bit lane < len in word j (ops/packing.len_lane_masks):
// a shift by 32 (no valid lane) masks to 0.
WALTX_HD uint32_t lane_mask(int64_t len, int j) {
  int64_t nv = len - 16 * (int64_t)j;
  nv = nv < 0 ? 0 : (nv > 16 ? 16 : nv);
  return nv == 0 ? 0u : (0x55555555u << (2 * (16 - (int)nv)));
}

// Python's // and % (floor) for a positive divisor.
WALTX_HD int64_t floor_div(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

WALTX_HD int64_t floor_mod(int64_t a, int64_t b) {
  const int64_t r = a % b;
  return r < 0 ? r + b : r;
}

// What a row fetches before it needs its read: the index entry, the window
// start and, with W a template constant, all W+1 genome words.
template <int kW>
struct StageFetch {
  uint32_t entry, gpos;
  int32_t shift;
  uint32_t g[kW > 0 ? kW + 1 : 1];
};

template <int kW>
WALTX_HD StageFetch<kW> stage_fetch(const StageArgs& a, const int32_t* shifts,
                                    int64_t seedi, int64_t eidx) {
  StageFetch<kW> f;
  const int64_t e = eidx < 0 ? 0 : (eidx > a.n_index - 1 ? a.n_index - 1 : eidx);
  f.entry = WALTX_LDG(a.index + e);
  f.shift = shifts[seedi];
  f.gpos = f.entry - (uint32_t)f.shift;  // wraps only on ~ok_head rows
  if constexpr (kW > 0) {
    const int64_t last = a.n_pseq - 1;
    const int64_t k0 = (int64_t)(f.gpos >> 4);
#pragma unroll
    for (int j = 0; j <= kW; ++j) {
      const int64_t k = k0 + j;
      f.g[j] = WALTX_LDG(a.pseq + (k < last ? k : last));
    }
  }
  return f;
}

// Chromosome of `entry` (torch.searchsorted(si, entry, right=True) - 1,
// torch's negative index included) and its [start, end) bounds.
WALTX_HD void chrom_bounds(const uint32_t* si, int n_si, uint32_t entry,
                           uint32_t* start, uint32_t* end) {
  int lo = 0, hi = n_si;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (si[mid] <= entry) lo = mid + 1; else hi = mid;
  }
  const int chrom = lo - 1;
  *start = si[chrom < 0 ? chrom + n_si : chrom];
  *end = si[chrom + 1 < n_si - 1 ? chrom + 1 : n_si - 1];
}

// The rest of the row: window, fold and count, the verify_skip
// corrections, ok_head / ok_tail, mm <= max_mm and the window cared check,
// with the window kept in registers.  `conv_row` is the row's read (W u32
// values in int64); `si`, `cared_mask`, `cared_off` may be shared memory.
template <int kW>
WALTX_HD void stage_finish(const StageArgs& a, const StageFetch<kW>& f,
                           const uint32_t* si, const uint32_t* cared_mask,
                           const int32_t* cared_off, const int64_t* conv_row,
                           int64_t seedi, bool valid, int64_t len, int64_t rep,
                           int64_t* gpos_out, int64_t* mm_out, uint8_t* keep_out) {
  const int W = kW > 0 ? kW : a.W;
  uint32_t ch_start, ch_end;
  chrom_bounds(si, a.n_si, f.entry, &ch_start, &ch_end);
  const bool ok_head = (uint32_t)(f.entry - ch_start) >= (uint32_t)f.shift;
  const bool ok_tail = (uint32_t)(f.gpos + (uint32_t)len) < ch_end;

  // lanes below cared[seed_len] + shift (cared is periodic-affine)
  int64_t slj = rep * a.cwt;
  if (slj > a.n_cared) slj = a.n_cared;
  const int64_t cutoff = floor_div(slj, a.cwt) * a.plen +
                         cared_off[floor_mod(slj, a.cwt)] + f.shift;
  const uint32_t* cmask = cared_mask + seedi * W;

  const uint32_t sh = (f.gpos & 15u) << 1;
  const int64_t last = a.n_pseq - 1;
  int64_t k = (int64_t)(f.gpos >> 4);
  uint32_t lo = kW > 0 ? f.g[0] : WALTX_LDG(a.pseq + (k < last ? k : last));
  int32_t count = 0;
  uint32_t viol = 0, skip_hit = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {  // fully unrolled when W is a constant
    uint32_t hi;
    if constexpr (kW > 0) {
      hi = f.g[j + 1];
    } else {
      ++k;
      hi = WALTX_LDG(a.pseq + (k < last ? k : last));
    }
    const uint32_t w = funnel_left(lo, hi, sh);
    lo = hi;
    const uint32_t d = w ^ (uint32_t)conv_row[j];
    const uint32_t fold = (d | (d >> 1)) & lane_mask(len, j);
    count += popcount32(fold);
    if (a.check) viol |= fold & cmask[j] & lane_mask(cutoff, j);
    for (int s = 0; s < a.n_skip; ++s) {
      const int p = a.skip_posn[s];
      if ((p >> 4) == j && ((d >> (30 - 2 * (p & 15))) & 3u)) skip_hit |= 1u << s;
    }
  }
  int64_t mm = count;
  for (int s = 0; s < a.n_skip; ++s) {
    mm -= (f.shift == a.skip_shift[s] && rep >= a.skip_min_rep[s] &&
           a.skip_posn[s] < len && ((skip_hit >> s) & 1u));
  }
  *gpos_out = (int64_t)f.gpos;
  *mm_out = mm;
  *keep_out = (uint8_t)(valid && ok_head && ok_tail && mm <= a.max_mm &&
                        !(a.check && viol));
}

}  // namespace waltx
