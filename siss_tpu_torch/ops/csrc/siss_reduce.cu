// SISS epilogue, forward: the four per-sample sums in one pass over memory.
//
// Replaces the Pallas kernel siss_tpu/ops/siss_pallas.py::_reduce_kernel
// (launched by _siss_reduce). For flattened [B, P] preds, mix, x_og, a_og
// (fp32 or bf16, all four the same type) and per-row gamma, 1/sigma:
//
//   dist_x[b] = sum (mix - g x_og)^2          dist_a[b] = sum (mix - g a_og)^2
//   lx[b]     = sum (preds - (mix - g x_og)/s)^2
//   la[b]     = sum (preds - (mix - g a_og)/s)^2
//
// accumulated in fp32. out is [4, B] in that order.
//
// Bound on an H100 SXM: it reads 4 B P elements and writes 4 B floats, so it
// is memory-bound. At the main path's B = 16, P = 256*256*3 in fp32 that is
// 50.3 MB, about 15 us at 3.35 TB/s; it does ~14 flops per element, far below
// the ~20 flops/byte where the fp32 units would limit it.
//
// Design: the TPU grid walks a row's tiles in order and carries the sums in
// its output block. Here blocks run in parallel, so each row is split into
// n_chunks contiguous chunks and each (chunk, row) is one block: with B = 16
// the rows alone would fill 16 of 132 SMs. A block reads its chunk with
// 16-byte loads (a scalar tail covers a chunk length that is not a multiple
// of the vector width), reduces the four sums with warp shuffles and shared
// memory, and writes them to partials [4, B, n_chunks]. A second small
// launch sums each row's partials in a fixed order. No atomics: the result
// repeats bit for bit from run to run.

#include "siss_common.cuh"

namespace siss {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
reduce_partial_kernel(const T* __restrict__ preds, const T* __restrict__ mix,
                      const T* __restrict__ xog, const T* __restrict__ aog,
                      const float* __restrict__ gamma, const float* __restrict__ inv_sigma,
                      float* __restrict__ partials, int B, long long P, long long chunk,
                      int n_chunks) {
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const long long start = (long long)c * chunk;
  const long long len = min(chunk, P - start);
  const long long base = (long long)b * P + start;
  const float g = gamma[b];
  const float is = inv_sigma[b];

  float s_dx = 0.f, s_da = 0.f, s_lx = 0.f, s_la = 0.f;
  auto accumulate = [&](float p, float m, float x, float a) {
    const float rx = m - g * x;
    const float ra = m - g * a;
    const float ex = p - rx * is;
    const float ea = p - ra * is;
    s_dx += rx * rx;
    s_da += ra * ra;
    s_lx += ex * ex;
    s_la += ea * ea;
  };

  const long long n_vec = len / VEC;
  for (long long i = threadIdx.x; i < n_vec; i += kThreads) {
    const long long off = base + i * VEC;
    float p[VEC], m[VEC], x[VEC], a[VEC];
    load_f32<T, VEC>(preds + off, p);
    load_f32<T, VEC>(mix + off, m);
    load_f32<T, VEC>(xog + off, x);
    load_f32<T, VEC>(aog + off, a);
#pragma unroll
    for (int k = 0; k < VEC; ++k) accumulate(p[k], m[k], x[k], a[k]);
  }
  for (long long i = n_vec * VEC + threadIdx.x; i < len; i += kThreads) {
    const long long off = base + i;
    accumulate(to_f32(preds[off]), to_f32(mix[off]), to_f32(xog[off]), to_f32(aog[off]));
  }

  __shared__ float smem[4][kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  s_dx = warp_sum(s_dx);
  s_da = warp_sum(s_da);
  s_lx = warp_sum(s_lx);
  s_la = warp_sum(s_la);
  if (lane == 0) {
    smem[0][warp] = s_dx;
    smem[1][warp] = s_da;
    smem[2][warp] = s_lx;
    smem[3][warp] = s_la;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v = lane < kThreads / 32 ? smem[q][lane] : 0.f;
      v = warp_sum(v);
      if (lane == 0) partials[((long long)q * B + b) * n_chunks + c] = v;
    }
  }
}

// out[q, b] = sum over c of partials[q, b, c], in order of c.
__global__ void reduce_final_kernel(const float* __restrict__ partials, float* __restrict__ out,
                                    int B, int n_chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 4 * B) return;
  const float* row = partials + (long long)i * n_chunks;
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s += row[c];
  out[i] = s;
}

template <typename T, int VEC>
void launch(const void* preds, const void* mix, const void* xog, const void* aog,
            const float* gamma, const float* inv_sigma, float* partials, float* out, int B,
            long long P, long long chunk, int n_chunks, cudaStream_t stream) {
  const dim3 grid(n_chunks, B);
  reduce_partial_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(preds), static_cast<const T*>(mix), static_cast<const T*>(xog),
      static_cast<const T*>(aog), gamma, inv_sigma, partials, B, P, chunk, n_chunks);
  reduce_final_kernel<<<(4 * B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partials, out, B, n_chunks);
}

}  // namespace siss

// dtype: 0 = fp32, 1 = bf16. vectorized: 1 when every row start is 16-byte
// aligned (checked by the caller), else 0 for one element per load.
// chunk must be a multiple of the vector width. Returns cudaGetLastError().
extern "C" int siss_reduce(const void* preds, const void* mix, const void* xog,
                           const void* aog, const void* gamma, const void* inv_sigma,
                           void* partials, void* out, int B, long long P, long long chunk,
                           int n_chunks, int dtype, int vectorized, void* stream) {
  using namespace siss;
  const float* g = static_cast<const float*>(gamma);
  const float* is = static_cast<const float*>(inv_sigma);
  float* part = static_cast<float*>(partials);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (vectorized) launch<float, 4>(preds, mix, xog, aog, g, is, part, o, B, P, chunk, n_chunks, s);
    else launch<float, 1>(preds, mix, xog, aog, g, is, part, o, B, P, chunk, n_chunks, s);
  } else if (dtype == 1) {
    if (vectorized) launch<__nv_bfloat16, 8>(preds, mix, xog, aog, g, is, part, o, B, P, chunk, n_chunks, s);
    else launch<__nv_bfloat16, 1>(preds, mix, xog, aog, g, is, part, o, B, P, chunk, n_chunks, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
