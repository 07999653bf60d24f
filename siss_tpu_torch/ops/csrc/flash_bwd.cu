// Flash attention, backward: dK and dV in one kernel, dQ in another, from
// q, k, v, the forward's lse, dO and di = rowsum(O * dO) (computed by the
// wrapper, as the TPU version computes it outside its kernels).
//
// Replaces the Pallas TPU kernels of
// jax/experimental/pallas/ops/tpu/flash_attention.py:
//   _flash_attention_dkv_kernel (launched by _flash_attention_bwd_dkv),
//   _flash_attention_dq_kernel  (launched by _flash_attention_bwd_dq).
// Same math. With s = (q . k) * scale recomputed in fp32:
//   p  = exp(s - lse)                dv += round(p) * do
//   dp = do . v                      ds  = (dp - di) * p * scale
//   dk += round(ds) * q              dq += round(ds) * k
// where round() casts to the operands' type (bf16 or fp32) as the TPU
// kernels do before their second product; sums are fp32, outputs in the
// operands' type.
//
// Both entry points dispatch on the operands' type: bf16 runs the
// tensor-core kernels of flash_bwd_dkv_sm90.cu and flash_bwd_dq_sm90.cu;
// fp32 dK/dV runs the 3xTF32 tensor-core kernel of flash_bwd_dkv_tf32x3.cu
// and fp32 dQ the FMA kernel below.
//
// Bound on an H100 SXM: by operations. dK/dV does 8 B H N^2 d of them (s,
// dv, dp, dk) and dQ 6 B H N^2 d (s, dp, dq): at (1, 8, 4096, 40) in bf16
// that is 43.4 us and 32.6 us at 989 TFLOP/s. The whole backward needs
// only 10 B H N^2 d (54.3 us) when one kernel produces all three
// gradients; splitting it, as the TPU version does, recomputes s and dp.
// The FMA dQ kernel runs on fp32 FMAs (67 TFLOP/s).
//
// Design of the FMA dQ (flash_common.cuh): each query row keeps its q, dO
// and dq in registers and streams k and v through shared memory. Each
// gradient row is written by exactly one block, so there are no atomics and
// the result repeats bit for bit.

#include "flash_common.cuh"

namespace flash {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const float* __restrict__ lse, const T* __restrict__ dout,
          const float* __restrict__ di, T* __restrict__ dq, int H, int N, int d, Strides sq,
          Strides sk, Strides sv, Strides sdo, Strides sdq, float scale) {
  using S = RowSplit<D>;
  __shared__ __align__(16) float ks[kTile * D];
  __shared__ __align__(16) float vs[kTile * D];
  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * S::ROWS + threadIdx.x / S::TPR;  // query row
  const int c0 = (threadIdx.x % S::TPR) * S::DH;

  float qr[S::DH], dor[S::DH], dq_acc[S::DH];
  load_row<T, S::DH>(qr, q + sq.row(b, h, row), c0, d);
  load_row<T, S::DH>(dor, dout + sdo.row(b, h, row), c0, d);
#pragma unroll
  for (int c = 0; c < S::DH; ++c) dq_acc[c] = 0.f;
  const long long bh = ((long long)b * H + h) * N;
  const float lse_row = lse[bh + row];
  const float di_row = di[bh + row];
  const T* kb = k + sk.row(b, h, 0);
  const T* vb = v + sv.row(b, h, 0);

  for (int n0 = 0; n0 < N; n0 += kTile) {
    __syncthreads();
    load_tile<T, D>(ks, kb + (long long)n0 * sk.n, sk.n, d);
    load_tile<T, D>(vs, vb + (long long)n0 * sv.n, sv.n, d);
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float s4[4], dp4[4];
      dot4<D, S::DH>(qr, ks, j, c0, s4);
      dot4<D, S::DH>(dor, vs, j, c0, dp4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float s = row_sum<S::TPR>(s4[r]) * scale;
        const float dp = row_sum<S::TPR>(dp4[r]);
        const float p = expf(s - lse_row);
        const float ds = (dp - di_row) * p * scale;
        axpy<D, S::DH>(dq_acc, round_to<T>(ds), ks, j + r, c0);
      }
    }
  }
  store_row<T, S::DH>(dq + sdq.row(b, h, row), dq_acc, c0, d);
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const float* lse, const void* dout,
              const float* di, void* dq, int B, int H, int N, int d, int D,
              const long long* strides, float scale, cudaStream_t stream) {
  const Strides sq = strides_at(strides, 0), sk = strides_at(strides, 1),
                sv = strides_at(strides, 2), sdo = strides_at(strides, 3),
                sdq = strides_at(strides, 4);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  T* dqp = static_cast<T*>(dq);
  switch (D) {
#define FLASH_DQ_CASE(DD)                                                                   \
  case DD:                                                                                \
    dq_kernel<T, DD><<<dim3(N / RowSplit<DD>::ROWS, H, B), kThreads, 0, stream>>>(        \
        qp, kp, vp, lse, dop, di, dqp, H, N, d, sq, sk, sv, sdo, sdq, scale);             \
    break;
    FLASH_HEAD_DIMS(FLASH_DQ_CASE)
#undef FLASH_DQ_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace flash

// q, k, v, dout, dk, dv: [B, H, N, d] operands with element strides in
// strides[0..17] (in that order; each batch, head, sequence). lse, di: fp32
// [B, H, N], contiguous. D, N and dtype as for flash_fwd: fp32 runs the
// 3xTF32 kernel, bf16 the wgmma kernel.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* lse,
                             const void* dout, const void* di, void* dk, void* dv, int B, int H,
                             int N, int d, int D, int dtype, const long long* strides,
                             float scale, void* stream) {
  using namespace flash;
  const float* l = static_cast<const float*>(lse);
  const float* t = static_cast<const float*>(di);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dkv_fp32_tf32x3(q, k, v, l, dout, t, dk, dv, B, H, N, d, D, strides, scale, s);
  if (dtype == 1)
    return launch_dkv_bf16_sm90(q, k, v, l, dout, t, dk, dv, B, H, N, d, D, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}

// As flash_bwd_dkv, with q, k, v, dout, dq in strides[0..14].
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* lse,
                            const void* dout, const void* di, void* dq, int B, int H, int N,
                            int d, int D, int dtype, const long long* strides, float scale,
                            void* stream) {
  using namespace flash;
  const float* l = static_cast<const float*>(lse);
  const float* t = static_cast<const float*>(di);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dq<float>(q, k, v, l, dout, t, dq, B, H, N, d, D, strides, scale, s);
  if (dtype == 1)
    return launch_dq_bf16_sm90(q, k, v, l, dout, t, dq, B, H, N, d, D, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}
