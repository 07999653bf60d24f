// Flash attention, forward: O = softmax(Q K^T * scale) V, and the row
// log-sum-exp lse = m + log(l) for the backward.
//
// Replaces the Pallas TPU kernel _flash_attention_kernel of
// jax/experimental/pallas/ops/tpu/flash_attention.py (launched by
// _flash_attention_impl), which the SD UNet calls at
// siss_tpu/models/unet2d_cond.py:155-158. Same math: fp32 logits, a running
// row max m and row sum l over key tiles, P cast to V's type before P V
// (that file's line 471), l summed from P before the cast, fp32 output
// accumulator, O in Q's type. The TPU kernel keeps l and m as residuals;
// this one keeps lse, which is all the backward needs.
//
// flash_fwd dispatches on the operands' type: bf16 runs the tensor-core
// kernel of flash_fwd_sm90.cu; fp32 runs the FMA kernel below, which keeps
// fp32 products (tensor cores would mean TF32) and so matches the fp32
// plain version to fp32 rounding.
//
// Bound on an H100 SXM: 4 B H N^2 d operations against a few MB of
// operands, so it is bound by operations; in fp32 outside the tensor cores
// (67 TFLOP/s) that is 320 us at (B, H, N, d) = (1, 8, 4096, 40).
//
// Design: one block per 128/TPR query rows of one (batch, head); each row
// keeps q and its output accumulator in registers, split over TPR lanes
// (flash_common.cuh). K and V stream through shared memory 32 rows at a
// time: logits for the tile, the tile's max, one rescale of the
// accumulator, then the P V update. No atomics: the result repeats bit for
// bit.

#include "flash_common.cuh"

namespace flash {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, int H, int N, int d, Strides sq,
           Strides sk, Strides sv, Strides so, float scale) {
  using S = RowSplit<D>;
  __shared__ __align__(16) float ks[kTile * D];
  __shared__ __align__(16) float vs[kTile * D];
  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * S::ROWS + threadIdx.x / S::TPR;
  const int c0 = (threadIdx.x % S::TPR) * S::DH;

  float qr[S::DH], acc[S::DH];
  load_row<T, S::DH>(qr, q + sq.row(b, h, row), c0, d);
#pragma unroll
  for (int c = 0; c < S::DH; ++c) acc[c] = 0.f;
  float m = -CUDART_INF_F, l = 0.f;
  const T* kb = k + sk.row(b, h, 0);
  const T* vb = v + sv.row(b, h, 0);

  for (int n0 = 0; n0 < N; n0 += kTile) {
    __syncthreads();  // every lane is done with the previous tile
    load_tile<T, D>(ks, kb + (long long)n0 * sk.n, sk.n, d);
    load_tile<T, D>(vs, vb + (long long)n0 * sv.n, sv.n, d);
    __syncthreads();

    float s[kTile];
#pragma unroll
    for (int j = 0; j < kTile; j += 4) {
      float part[4];
      dot4<D, S::DH>(qr, ks, j, c0, part);
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j + r] = row_sum<S::TPR>(part[r]) * scale;
    }
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kTile; ++j) m_new = fmaxf(m_new, s[j]);
    const float alpha = expf(m - m_new);  // 0 on the first tile, where m = -inf
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      s[j] = expf(s[j] - m_new);
      p_sum += s[j];
    }
    l = l * alpha + p_sum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < S::DH; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < kTile; ++j) axpy<D, S::DH>(acc, round_to<T>(s[j]), vs, j, c0);
  }

  float out[S::DH];
#pragma unroll
  for (int c = 0; c < S::DH; ++c) out[c] = acc[c] / l;
  store_row<T, S::DH>(o + so.row(b, h, row), out, c0, d);
  if (threadIdx.x % S::TPR == 0) lse[((long long)b * H + h) * N + row] = m + logf(l);
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
               int N, int d, int D, const long long* strides, float scale, cudaStream_t stream) {
  const Strides sq = strides_at(strides, 0), sk = strides_at(strides, 1),
                sv = strides_at(strides, 2), so = strides_at(strides, 3);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  switch (D) {
#define FLASH_FWD_CASE(DD)                                                                  \
  case DD:                                                                                \
    fwd_kernel<T, DD><<<dim3(N / RowSplit<DD>::ROWS, H, B), kThreads, 0, stream>>>(       \
        qp, kp, vp, op, lse, H, N, d, sq, sk, sv, so, scale);                             \
    break;
    FLASH_HEAD_DIMS(FLASH_FWD_CASE)
#undef FLASH_FWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace flash

// q, k, v, o: [B, H, N, d] operands with the element strides in
// strides[0..11] (q, k, v, o; each batch, head, sequence). lse: fp32
// [B, H, N], contiguous. D: d padded up to a built head dim. N must be a
// multiple of 128 (checked by the caller). dtype: 0 = fp32 (FMA kernel),
// 1 = bf16 (tensor-core kernel). Returns cudaGetLastError().
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                         int H, int N, int d, int D, int dtype, const long long* strides,
                         float scale, void* stream) {
  using namespace flash;
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(q, k, v, o, l, B, H, N, d, D, strides, scale, s);
  if (dtype == 1) return launch_fwd_bf16_sm90(q, k, v, o, l, B, H, N, d, D, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}
