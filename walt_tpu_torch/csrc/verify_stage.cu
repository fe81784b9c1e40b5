// Fused verify-stage kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the verify stage of walt_tpu/ops/pipeline.py (map_strand_core,
// lines 555-665): the worklist rows' index gather, the chromosome search,
// ok_head / ok_tail, the converted-read gather, the candidate-verify Pallas
// kernel walt_tpu/ops/pallas_verify.py::_verify_kernel (gather W+1 packed
// genome words at gpos >> 4, funnel-align by 2 * (gpos & 15), XOR with the
// converted read, OR-fold each 2-bit lane, count under the length mask),
// the verify_skip corrections, the keep mask and the window cared check.
// On the port's earlier path this was about 70-80 small torch ops on int64
// (M, W) tensors around csrc/verify.cu, and the window went to device
// memory and back.  The per-row body is csrc/verify_stage_row.h; the plain
// PyTorch version is walt_tpu_torch/ops/verify.py::verify_worklist_reference.
//
// What bounds it on the card: memory and gathers, not arithmetic.  Counted
// once, a row reads its three int64 indices and valid flag (25 B), one
// index entry (4 B) and W+1 genome words (32 B at W = 7), and writes gpos
// and mm as int64 and keep (17 B); a read's conv (8W B), length and repeat
// count (16 B) are shared by its rows (about 1.5 rows per read on the SE
// main path).  That is about 126 B a row: 24.8 MB, or 7.4 us at 3.35 TB/s,
// at the SE shape (M = 196,608, W = 7).  The integer work (a funnel shift,
// XOR, OR-fold and popcount per word, a binary search over a few chromosome
// starts) is a few hundred operations a row, far below the card's integer
// rate.  Tensor cores, wgmma and TMA tiles have nothing to do here: there is
// no matrix product, and the genome gathers are scattered 32-byte reads, not
// tiles.
//
// Design against that bound:
// - W is a template constant for W <= 16 (reads up to 256 bp): the word loop
//   is fully unrolled and all W+1 genome loads (__ldg) are issued at once,
//   before the block waits for anything else; a runtime-W instance serves
//   longer reads;
// - the window stays in registers: the fold, the verify_skip lanes and the
//   cared check read it there, and the lane and cutoff masks are computed
//   from the length in registers, so neither (M, W) window nor mask tensor
//   exists;
// - conv is gathered from the (B, W) read table inside the kernel.  Rows
//   come in read order, so a block's reads form a contiguous range: it is
//   staged into shared memory with 16-byte cp.async copies when it fits,
//   else rows read it directly;
// - start_index sits in shared memory with the chromosome search done there
//   (a global-memory search when it has more than 2048 entries);
// - the small constants (seed shifts, verify_skip triples, the (S, W)
//   cared-lane mask, cared[:cwt]) come in the by-value kernel parameter, so
//   a launch makes no host-to-device copy;
// - outputs are written one element per thread, consecutive rows by
//   consecutive threads: coalesced.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "device_guard.h"
#include "verify_stage_row.h"

namespace {

constexpr int kThreads = 256;
constexpr int kSiSmemMax = 2048;          // start_index entries staged
constexpr int kConvSmemMax = 36 * 1024;   // bytes of a staged conv range

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

template <int kW>
__global__ void __launch_bounds__(kThreads)
    verify_stage_kernel(const __grid_constant__ waltx::StageArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_lo, s_hi;
  const int W = kW > 0 ? kW : a.W;
  // layout: staged conv range | start_index | cared mask | cared_off
  uint32_t* si_s = reinterpret_cast<uint32_t*>(smem + a.conv_smem_bytes);
  uint32_t* cm_s = si_s + (a.si_smem ? a.n_si : 0);
  int32_t* off_s = reinterpret_cast<int32_t*>(cm_s + a.S * W);

  const int tid = threadIdx.x;
  for (int i = tid; i < a.S * W; i += kThreads) cm_s[i] = a.cared_mask[i];
  if (tid < waltx::kStageMaxCwt) off_s[tid] = a.cared_off[tid];
  if (a.si_smem)
    for (int i = tid; i < a.n_si; i += kThreads) si_s[i] = a.start_index[i];
  if (tid == 0) {
    s_lo = INT_MAX;
    s_hi = -1;
  }

  const int64_t m = (int64_t)blockIdx.x * kThreads + tid;
  const bool in = m < a.M;
  int64_t read = 0, seedi = 0, eidx = 0;
  bool valid = false;
  if (in) {
    read = a.wl_read[m];
    seedi = a.wl_seedi[m];
    eidx = a.wl_entryidx[m];
    valid = a.wl_valid[m] != 0;
  }
  // the index entry and the genome words go out before the block waits
  waltx::StageFetch<kW> f{};
  if (in) f = waltx::stage_fetch<kW>(a, a.shifts, seedi, eidx);
  // the block's read range: a warp reduction, then one atomic per warp
  const int lo_w = __reduce_min_sync(0xffffffffu, in && valid ? (int)read
                                                              : INT_MAX);
  const int hi_w = __reduce_max_sync(0xffffffffu, in && valid ? (int)read
                                                              : -1);
  __syncthreads();  // the tables above and s_lo / s_hi are initialised
  if ((tid & 31) == 0 && hi_w >= 0) {
    atomicMin(&s_lo, lo_w);
    atomicMax(&s_hi, hi_w);
  }
  __syncthreads();

  // stage the block's reads [lo, hi] of conv when the range fits
  const int lo = s_lo, hi = s_hi;
  const int64_t* conv_s = nullptr;
  if (hi >= lo) {
    const int64_t row_bytes = (int64_t)W * 8;
    const int64_t b0 = lo * row_bytes, b1 = (hi + 1) * row_bytes;
    const int64_t a0 = b0 & ~(int64_t)15, end16 = (b1 + 15) & ~(int64_t)15;
    if (end16 - a0 <= a.conv_smem_bytes) {  // the same in every thread
      const int64_t total = a.B * row_bytes;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(a.conv);
      // full 16-byte chunks inside the tensor; an 8-byte tail at its end
      const int64_t stop = end16 <= total ? end16 : (total & ~(int64_t)15);
      for (int64_t off = a0 + 16 * tid; off < stop; off += 16 * kThreads)
        cp_async16(smem + (off - a0), src + off);
      if (stop < b1 && tid == 0)
        *reinterpret_cast<int64_t*>(smem + (stop - a0)) =
            *reinterpret_cast<const int64_t*>(src + stop);
      cp_async_wait_all();
      __syncthreads();
      conv_s = reinterpret_cast<const int64_t*>(smem + (b0 - a0));
    }
  }
  if (!in) return;

  const int64_t* crow = (conv_s != nullptr && valid)
                            ? conv_s + (read - lo) * W
                            : a.conv + read * W;
  const int64_t len = __ldg(reinterpret_cast<const long long*>(a.lens) + read);
  const int64_t rep =
      __ldg(reinterpret_cast<const long long*>(a.repeats) + read);
  waltx::stage_finish<kW>(a, f, a.si_smem ? si_s : a.start_index, cm_s, off_s,
                          crow, seedi, valid, len, rep, a.gpos + m, a.mm + m,
                          a.keep + m);
}

template <int kW>
cudaError_t launch(const waltx::StageArgs& a, size_t smem,
                   cudaStream_t stream) {
  const int64_t blocks = (a.M + kThreads - 1) / kThreads;
  verify_stage_kernel<kW><<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// sizeof(StageArgs), for the wrapper's check of its ctypes mirror.
extern "C" int waltx_verify_stage_args_size() {
  return (int)sizeof(waltx::StageArgs);
}

// Launches the fused verify stage described by *args on `stream` (a
// cudaStream_t) of device `device`; the calling thread's current device is
// left as it was.  The staging fields (conv_smem_bytes, si_smem) are set
// here.  Returns cudaGetLastError() after the launch: 0 when it was
// accepted.
extern "C" int waltx_verify_stage(const waltx::StageArgs* args, int device,
                                  void* stream) {
  waltx::StageArgs a = *args;
  if (a.M <= 0) return 0;
  if (a.W < 1 || a.W > waltx::kStageMaxW || a.S < 1 ||
      a.S > waltx::kStageMaxSeeds || a.n_skip < 0 ||
      a.n_skip > waltx::kStageMaxSkips || a.cwt < 1 ||
      a.cwt > waltx::kStageMaxCwt || a.n_si < 1 || a.B < 1 ||
      a.n_index < 1 || a.n_pseq < 1 ||
      (a.M + kThreads - 1) / kThreads > INT_MAX)
    return (int)cudaErrorInvalidValue;
  a.si_smem = a.n_si <= kSiSmemMax;
  // room for two reads per row of a block, 16-byte aligned, plus slack
  int64_t conv_cap = ((int64_t)2 * kThreads * a.W * 8 + 16 + 15) & ~15;
  a.conv_smem_bytes = (int32_t)(conv_cap < kConvSmemMax ? conv_cap
                                                        : kConvSmemMax);
  const size_t smem = (size_t)a.conv_smem_bytes +
                      (a.si_smem ? (size_t)a.n_si * 4 : 0) +
                      (size_t)a.S * a.W * 4 + waltx::kStageMaxCwt * 4;
  const cudaStream_t s = (cudaStream_t)stream;
  return waltx::on_device(device, [&] {
    switch (a.W) {
#define WALTX_CASE(w) \
  case w:             \
    return launch<w>(a, smem, s);
      WALTX_CASE(1) WALTX_CASE(2) WALTX_CASE(3) WALTX_CASE(4)
      WALTX_CASE(5) WALTX_CASE(6) WALTX_CASE(7) WALTX_CASE(8)
      WALTX_CASE(9) WALTX_CASE(10) WALTX_CASE(11) WALTX_CASE(12)
      WALTX_CASE(13) WALTX_CASE(14) WALTX_CASE(15) WALTX_CASE(16)
#undef WALTX_CASE
      default:
        return launch<0>(a, smem, s);
    }
  });
}
