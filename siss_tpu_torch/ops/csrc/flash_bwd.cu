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
// Both entry points dispatch on the operands' type, and every kernel runs
// on Hopper's tensor cores: bf16 runs the wgmma kernels of
// flash_bwd_dkv_sm90.cu and flash_bwd_dq_sm90.cu; fp32 runs the 3xTF32
// mma.sync kernels of flash_bwd_dkv_tf32x3.cu and flash_bwd_dq_tf32x3.cu.
//
// Bound on an H100 SXM: by operations. dK/dV does 8 B H N^2 d of them (s,
// dv, dp, dk) and dQ 6 B H N^2 d (s, dp, dq): at (1, 8, 4096, 40) in bf16
// that is 43.4 us and 32.6 us at 989 TFLOP/s. The whole backward needs
// only 10 B H N^2 d (54.3 us) when one kernel produces all three
// gradients; splitting it, as the TPU version does, recomputes s and dp.
// Each kernel's source note gives its own bound and design.

#include "flash_common.cuh"

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
  if (dtype == 0)
    return launch_dq_fp32_tf32x3(q, k, v, l, dout, t, dq, B, H, N, d, D, strides, scale, s);
  if (dtype == 1)
    return launch_dq_bf16_sm90(q, k, v, l, dout, t, dq, B, H, N, d, D, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}
