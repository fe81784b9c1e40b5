// Per-row body of the candidate-verify kernel (csrc/verify.cu).
//
// Kept in a header with no CUDA-only code outside __CUDA_ARCH__ blocks so
// that g++ can build the same arithmetic for a ctypes test on a machine
// without a GPU (tests/test_torch_verify.py).
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define WALTX_HD __host__ __device__ __forceinline__
#else
#define WALTX_HD static inline
#endif

namespace waltx {

// Bases first..first+15 of a window that starts sh/2 bases into `first`:
// the high word of (first:next) << sh, which is `first` itself when sh == 0.
WALTX_HD uint32_t funnel_left(uint32_t first, uint32_t next, uint32_t sh) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_l(next, first, sh);
#else
  return sh ? (first << sh) | (next >> (32u - sh)) : first;
#endif
}

WALTX_HD int32_t popcount32(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// One worklist row: gather the W+1 packed genome words from word gpos>>4
// (each index clamped to the last word, as JAX's mode="clip" gather does),
// align them by sh = 2*(gpos&15) bits into win[0..W), and count the
// mismatching 2-bit lanes under the read-length mask:
//   mm = sum_j popcount((d | d >> 1) & lane[j]),  d = win[j] ^ conv[j].
WALTX_HD void verify_row(const uint32_t* pseq, int64_t n_pseq, uint32_t gpos,
                         const uint32_t* conv, const uint32_t* lane, int W,
                         int32_t* mm, uint32_t* win) {
  const int64_t last = n_pseq - 1;
  const uint32_t sh = (gpos & 15u) << 1;
  int64_t k = (int64_t)(gpos >> 4);
  uint32_t lo = pseq[k < last ? k : last];
  int32_t count = 0;
  for (int j = 0; j < W; ++j) {
    ++k;
    const uint32_t hi = pseq[k < last ? k : last];
    const uint32_t w = funnel_left(lo, hi, sh);
    win[j] = w;
    const uint32_t d = w ^ conv[j];
    count += popcount32((d | (d >> 1)) & lane[j]);
    lo = hi;
  }
  *mm = count;
}

}  // namespace waltx
