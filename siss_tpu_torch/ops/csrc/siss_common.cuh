// Shared device helpers for the SISS epilogue kernels (siss_reduce.cu,
// siss_bwd.cu): 16-byte vector loads that widen fp32 or bf16 to fp32 in
// registers, and fp32 vector stores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace siss {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Read VEC elements of T starting at src and widen them to fp32. When the
// VEC elements fill 16 bytes the read is one 128-bit load; src must then be
// 16-byte aligned (the wrapper checks the base pointers and the row length).
template <typename T, int VEC>
__device__ __forceinline__ void load_f32(const T* __restrict__ src, float (&dst)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC; ++k) dst[k] = to_f32(e[k]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) dst[k] = to_f32(src[k]);
  }
}

// Write VEC fp32 values; 128-bit stores when VEC is a multiple of 4.
template <int VEC>
__device__ __forceinline__ void store_f32(float* __restrict__ dst, const float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j)
      reinterpret_cast<float4*>(dst)[j] =
          make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) dst[k] = v[k];
  }
}

}  // namespace siss
