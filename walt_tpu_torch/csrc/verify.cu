// Candidate-verify kernel (K1) for NVIDIA Hopper (sm_90a).
//
// Replaces walt_tpu/ops/pallas_verify.py::_verify_kernel, the Pallas TPU
// kernel behind the verify step of walt_tpu/ops/pipeline.py
// (map_strand_core).  For each worklist row m it gathers the W+1 packed
// genome words at word gpos[m]>>4, funnel-shifts them into the aligned
// window win[m, 0..W), XORs against the converted read words, OR-folds each
// 2-bit lane and counts mismatching lanes under the read-length mask.
// The per-row body is csrc/verify_row.h; the plain PyTorch version is
// walt_tpu_torch/ops/verify.py::verify_windows_reference.
//
// What bounds it on the card: every row does dependent random gathers of
// (W+1)*4 bytes from the packed genome, so the kernel is bound by memory
// latency, not by ALU work (funnel shift, xor, popc are single
// instructions).  At the main-path shape (M ~= 196k rows, W = 7) one launch
// moves about 24 MB, a few microseconds of HBM time, so launch overhead
// will probably dominate.
//
// Design: one thread per row, looping over j < W with the previous word
// kept in a register as the next window's low half; the pseq gather that
// XLA ran outside the Pallas kernel is fused in.  The public (M, W) layout
// is kept: the TPU kernel's lane-major (W, M) layout was a fix for the
// TPU's (8, 128) tiling and has no purpose here.  Left for later: coalesced
// conv/lane loads with one warp per row group, fusing the verify_skip and
// cared checks so that win never goes back to memory, and CUDA graphs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.h"
#include "verify_row.h"

namespace {

constexpr int kThreads = 256;

__global__ void verify_kernel(const uint32_t* __restrict__ pseq,
                              int64_t n_pseq,
                              const uint32_t* __restrict__ gpos,
                              const uint32_t* __restrict__ conv,
                              const uint32_t* __restrict__ lane, int64_t M,
                              int W, int32_t* __restrict__ mm,
                              uint32_t* __restrict__ win) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t m = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; m < M;
       m += stride) {
    waltx::verify_row(pseq, n_pseq, gpos[m], conv + m * W, lane + m * W, W,
                      mm + m, win + m * W);
  }
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) of device `device`; the
// calling thread's current device is left as it was.  Returns
// cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int waltx_verify(const void* pseq, int64_t n_pseq, const void* gpos,
                            const void* conv, const void* lane, int64_t M,
                            int W, void* mm, void* win, int device,
                            void* stream) {
  if (M <= 0) return 0;
  return waltx::on_device(device, [&] {
    int64_t blocks = (M + kThreads - 1) / kThreads;
    if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride covers the rest
    verify_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)pseq, n_pseq, (const uint32_t*)gpos,
        (const uint32_t*)conv, (const uint32_t*)lane, M, W, (int32_t*)mm,
        (uint32_t*)win);
    return cudaGetLastError();
  });
}
