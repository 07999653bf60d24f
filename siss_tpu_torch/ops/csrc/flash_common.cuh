// Shared pieces of the flash-attention kernels: the C entry points of
// flash_fwd.cu and flash_bwd.cu dispatch to the bf16 tensor-core kernels of
// flash_fwd_sm90.cu, flash_bwd_dkv_sm90.cu and flash_bwd_dq_sm90.cu, whose
// own pieces are in flash_sm90.cuh, and to the fp32 tensor-core forward,
// dK/dV and dQ of flash_fwd_tf32x3.cu, flash_bwd_dkv_tf32x3.cu and
// flash_bwd_dq_tf32x3.cu, whose own pieces are in flash_tf32x3.cuh.
//
// Every operand is a [B, H, N, d] tensor given by its element strides, with
// the head dimension contiguous, so the kernels read q, k and v straight
// from the [B, N, H, d] outputs of the to_q/to_k/to_v projections and write
// o, dq, dk and dv in that layout too. Sums and softmax are fp32.
//
// The head dimension d is padded to D, one of 8, 16, 40, 64, 80, 128: the
// padded columns are zero in shared memory and registers and are
// never stored.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace flash {

// Element strides of a [B, H, N, d] operand whose last dimension is contiguous.
struct Strides {
  long long b, h, n;
  __device__ __forceinline__ long long row(int bi, int hi, int ni) const {
    return bi * b + hi * h + (long long)ni * n;
  }
};

// The strides array a wrapper passes: for each operand in order, its
// element strides over (batch, head, sequence).
inline Strides strides_at(const long long* s, int i) {
  return {s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// The bf16 kernels on Hopper's tensor cores, with the arguments of
// flash_fwd, flash_bwd_dkv and flash_bwd_dq (bf16 operands; lse and di fp32).
int launch_fwd_bf16_sm90(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                         int H, int N, int d, int D, const long long* strides, float scale,
                         cudaStream_t stream);
int launch_dkv_bf16_sm90(const void* q, const void* k, const void* v, const float* lse,
                         const void* dout, const float* di, void* dk, void* dv, int B, int H,
                         int N, int d, int D, const long long* strides, float scale,
                         cudaStream_t stream);
int launch_dq_bf16_sm90(const void* q, const void* k, const void* v, const float* lse,
                        const void* dout, const float* di, void* dq, int B, int H, int N, int d,
                        int D, const long long* strides, float scale, cudaStream_t stream);
// The fp32 forward on Hopper's tensor cores (3xTF32), with flash_fwd's arguments.
int launch_fwd_fp32_tf32x3(const void* q, const void* k, const void* v, void* o, float* lse,
                           int B, int H, int N, int d, int D, const long long* strides,
                           float scale, cudaStream_t stream);
// The fp32 dK/dV on Hopper's tensor cores (3xTF32), with flash_bwd_dkv's arguments.
int launch_dkv_fp32_tf32x3(const void* q, const void* k, const void* v, const float* lse,
                           const void* dout, const float* di, void* dk, void* dv, int B, int H,
                           int N, int d, int D, const long long* strides, float scale,
                           cudaStream_t stream);
// The fp32 dQ on Hopper's tensor cores (3xTF32), with flash_bwd_dq's arguments.
int launch_dq_fp32_tf32x3(const void* q, const void* k, const void* v, const float* lse,
                          const void* dout, const float* di, void* dq, int B, int H, int N,
                          int d, int D, const long long* strides, float scale,
                          cudaStream_t stream);

}  // namespace flash

// The padded head dims the kernels are built for; X(D) for each. The
// wrapper (ops/flash_attention.py) pads d up to the next one.
#define FLASH_HEAD_DIMS(X) X(8) X(16) X(40) X(64) X(80) X(128)
