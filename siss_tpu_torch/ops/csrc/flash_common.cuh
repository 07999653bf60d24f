// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu,
// the bf16 tensor-core kernels of flash_fwd_sm90.cu, flash_bwd_dkv_sm90.cu
// and flash_bwd_dq_sm90.cu, whose own pieces are in flash_sm90.cuh, and the
// fp32 tensor-core forward and dK/dV of flash_fwd_tf32x3.cu and
// flash_bwd_dkv_tf32x3.cu, whose own pieces are in flash_tf32x3.cuh).
//
// Every operand is a [B, H, N, d] tensor given by its element strides, with
// the head dimension contiguous, so the kernels read q, k and v straight
// from the [B, N, H, d] outputs of the to_q/to_k/to_v projections and write
// o, dq, dk and dv in that layout too. All arithmetic is fp32.
//
// The FMA helpers below serve the fp32 dQ kernel. Work split: each block
// owns ROWS rows of one (batch, head) of the "row" operand (queries for
// dQ) and streams the other operand through shared memory in tiles of
// kTile rows, converted to fp32 once per tile. A row's head dimension is
// split over TPR neighbouring lanes, DH columns each, so a row's accumulators stay in
// registers at every head dim up to 128; a dot product over the head
// dimension is summed across those lanes with shuffles. All lanes of a block
// read the same tile row at once, so the shared-memory reads are broadcasts.
//
// The head dimension d is padded to D, one of 8, 16, 40, 64, 80, 128: the
// padded columns are zero in shared memory and registers and are
// never stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace flash {

constexpr int kThreads = 128;  // threads per block
constexpr int kTile = 32;      // rows of the streamed operand per shared-memory tile

// Element strides of a [B, H, N, d] operand whose last dimension is contiguous.
struct Strides {
  long long b, h, n;
  __device__ __forceinline__ long long row(int bi, int hi, int ni) const {
    return bi * b + hi * h + (long long)ni * n;
  }
};

template <int D>
struct RowSplit {
  static constexpr int TPR = D <= 16 ? 1 : (D <= 64 ? 2 : 4);  // lanes per row
  static constexpr int DH = D / TPR;                            // columns per lane
  static constexpr int ROWS = kThreads / TPR;                   // rows per block
  static_assert(DH % 4 == 0, "a lane's columns must fill whole float4 reads");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and widened back: the casts the TPU kernels apply to P and
// dS before their second matrix product.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// Sum of x over the TPR lanes of one row. Every lane gets the same bits:
// each sees the same pairs added in the same tree.
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [0, kTile) of a strided operand into shared memory as fp32, row
// stride D, columns d..D-1 zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const T* __restrict__ src,
                                          long long row_stride, int d) {
#pragma unroll 4
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    dst[e] = c < d ? to_f32(src[r * row_stride + c]) : 0.f;
  }
}

// This lane's DH columns of one row, starting at column c0, zero past d.
template <typename T, int DH>
__device__ __forceinline__ void load_row(float (&dst)[DH], const T* __restrict__ src, int c0,
                                         int d) {
#pragma unroll
  for (int c = 0; c < DH; ++c) dst[c] = c0 + c < d ? to_f32(src[c0 + c]) : 0.f;
}

template <typename T, int DH>
__device__ __forceinline__ void store_row(T* __restrict__ dst, const float (&val)[DH], int c0,
                                          int d) {
#pragma unroll
  for (int c = 0; c < DH; ++c)
    if (c0 + c < d) dst[c0 + c] = from_f32<T>(val[c]);
}

// Partial dot products of this lane's columns of x with tile rows j..j+3:
// four independent FMA chains, one float4 broadcast read per four FMAs.
template <int D, int DH>
__device__ __forceinline__ void dot4(const float (&x)[DH], const float* __restrict__ tile, int j,
                                     int c0, float (&out)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) out[r] = 0.f;
#pragma unroll
  for (int c = 0; c < DH; c += 4) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 t = *reinterpret_cast<const float4*>(tile + (j + r) * D + c0 + c);
      out[r] = fmaf(x[c], t.x, out[r]);
      out[r] = fmaf(x[c + 1], t.y, out[r]);
      out[r] = fmaf(x[c + 2], t.z, out[r]);
      out[r] = fmaf(x[c + 3], t.w, out[r]);
    }
  }
}

// acc += w * (this lane's columns of tile row j).
template <int D, int DH>
__device__ __forceinline__ void axpy(float (&acc)[DH], float w, const float* __restrict__ tile,
                                     int j, int c0) {
#pragma unroll
  for (int c = 0; c < DH; c += 4) {
    const float4 t = *reinterpret_cast<const float4*>(tile + j * D + c0 + c);
    acc[c] = fmaf(w, t.x, acc[c]);
    acc[c + 1] = fmaf(w, t.y, acc[c + 1]);
    acc[c + 2] = fmaf(w, t.z, acc[c + 2]);
    acc[c + 3] = fmaf(w, t.w, acc[c + 3]);
  }
}

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

}  // namespace flash

// The padded head dims the kernels are built for; X(D) for each. The
// wrapper (ops/flash_attention.py) pads d up to the next one.
#define FLASH_HEAD_DIMS(X) X(8) X(16) X(40) X(64) X(80) X(128)
