// An empty kernel, launched through the same ctypes binding and on the same
// PyTorch stream as the SISS kernels. It replaces no TPU kernel: its time on
// the card is the launch floor under any kernel of this library, which
// chip_smoke.py prints beside the SISS kernels' bounds (at the SD step's
// [1, 16384] those bounds, 78 and 98 ns, are far below one launch).

#include <cuda_runtime.h>

__global__ void empty_kernel() {}

// Launch the empty kernel n times, one block of 256 threads each, on
// `stream`. Returns cudaGetLastError().
extern "C" int empty_launches(int n, void* stream) {
  for (int i = 0; i < n; ++i) {
    empty_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>();
  }
  return (int)cudaGetLastError();
}
