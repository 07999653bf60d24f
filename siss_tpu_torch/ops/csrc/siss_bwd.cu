// SISS epilogue, backward: the gradient of the two weighted sums w.r.t. preds.
//
// Replaces the Pallas kernel siss_tpu/ops/siss_pallas.py::_bwd_kernel
// (launched by _siss_grad_preds). With per-row cx = cot_x iw_x,
// ca = cot_a iw_a, gamma and 1/sigma:
//
//   grad[b, i] = 2 (cx e_x + ca e_a),   e_x = preds - (mix - g x_og)/s,
//                                        e_a = preds - (mix - g a_og)/s
//
// e_x and e_a are recomputed in registers, so no eps or weighted-loss tensor
// is ever stored. Inputs are fp32 or bf16 (all four the same type); the
// output is fp32, as in the reference.
//
// Bound on an H100 SXM: it reads 4 [B, P] tensors and writes one fp32
// [B, P], so it is memory-bound. At B = 16, P = 256*256*3 in fp32 that is
// 62.9 MB, about 19 us at 3.35 TB/s.
//
// Design: one elementwise pass. Grid (ceil(P / (VEC * threads)), B): each
// thread reads VEC elements of one row with 16-byte loads, reads the row's
// four scalars once, and writes VEC outputs with 16-byte stores; a scalar
// tail covers a row length that is not a multiple of VEC.

#include "siss_common.cuh"

namespace siss {

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const T* __restrict__ preds, const T* __restrict__ mix, const T* __restrict__ xog,
           const T* __restrict__ aog, const float* __restrict__ gamma,
           const float* __restrict__ inv_sigma, const float* __restrict__ cx,
           const float* __restrict__ ca, float* __restrict__ grad, long long P) {
  const int b = blockIdx.y;
  const long long idx = ((long long)blockIdx.x * kThreads + threadIdx.x) * VEC;
  if (idx >= P) return;
  const float g = gamma[b];
  const float is = inv_sigma[b];
  const float wx = 2.f * cx[b];
  const float wa = 2.f * ca[b];
  const long long off = (long long)b * P + idx;
  if (idx + VEC <= P) {
    float p[VEC], m[VEC], x[VEC], a[VEC], out[VEC];
    load_f32<T, VEC>(preds + off, p);
    load_f32<T, VEC>(mix + off, m);
    load_f32<T, VEC>(xog + off, x);
    load_f32<T, VEC>(aog + off, a);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float ex = p[k] - (m[k] - g * x[k]) * is;
      const float ea = p[k] - (m[k] - g * a[k]) * is;
      out[k] = wx * ex + wa * ea;
    }
    store_f32<VEC>(grad + off, out);
  } else {
    for (long long i = 0; idx + i < P; ++i) {
      const float pk = to_f32(preds[off + i]);
      const float mk = to_f32(mix[off + i]);
      const float ex = pk - (mk - g * to_f32(xog[off + i])) * is;
      const float ea = pk - (mk - g * to_f32(aog[off + i])) * is;
      grad[off + i] = wx * ex + wa * ea;
    }
  }
}

template <typename T, int VEC>
void launch(const void* preds, const void* mix, const void* xog, const void* aog,
            const float* gamma, const float* inv_sigma, const float* cx, const float* ca,
            float* grad, int B, long long P, cudaStream_t stream) {
  const long long per_block = (long long)kThreads * VEC;
  const dim3 grid((unsigned)((P + per_block - 1) / per_block), B);
  bwd_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(preds), static_cast<const T*>(mix), static_cast<const T*>(xog),
      static_cast<const T*>(aog), gamma, inv_sigma, cx, ca, grad, P);
}

}  // namespace siss

// dtype: 0 = fp32, 1 = bf16. vectorized: 1 when every row start of the
// inputs and of grad is 16-byte aligned (checked by the caller). Returns
// cudaGetLastError().
extern "C" int siss_bwd(const void* preds, const void* mix, const void* xog, const void* aog,
                        const void* gamma, const void* inv_sigma, const void* cx,
                        const void* ca, void* grad, int B, long long P, int dtype,
                        int vectorized, void* stream) {
  using namespace siss;
  const float* g = static_cast<const float*>(gamma);
  const float* is = static_cast<const float*>(inv_sigma);
  const float* x = static_cast<const float*>(cx);
  const float* a = static_cast<const float*>(ca);
  float* out = static_cast<float*>(grad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (vectorized) launch<float, 4>(preds, mix, xog, aog, g, is, x, a, out, B, P, s);
    else launch<float, 1>(preds, mix, xog, aog, g, is, x, a, out, B, P, s);
  } else if (dtype == 1) {
    if (vectorized) launch<__nv_bfloat16, 8>(preds, mix, xog, aog, g, is, x, a, out, B, P, s);
    else launch<__nv_bfloat16, 1>(preds, mix, xog, aog, g, is, x, a, out, B, P, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
