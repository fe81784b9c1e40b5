// Runs a launch on a given device and puts the calling thread's current
// device back as it found it, on the error paths too.  The CUDA runtime's
// current device is per host thread: an entry point that left it moved
// would change which card torch.device("cuda") names for its caller.
#pragma once

#include <cuda_runtime.h>

namespace waltx {

// launch() runs with `device` current and returns a cudaError_t; the
// result is the first error among setting the device, the launch and
// setting it back.
template <typename Launch>
int on_device(int device, Launch launch) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
  }
  err = launch();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

}  // namespace waltx
