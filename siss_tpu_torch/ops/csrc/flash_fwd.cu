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
// these keep lse, which is all the backward needs.
//
// flash_fwd dispatches on the operands' type, and both kernels run on
// Hopper's tensor cores: bf16 runs the wgmma kernel of flash_fwd_sm90.cu;
// fp32 runs the kernel of flash_fwd_tf32x3.cu, which splits every fp32
// operand into two TF32 parts and issues each product three times (3xTF32),
// so its products keep fp32 accuracy where plain TF32 would keep ~3 decimal
// digits.

#include "flash_common.cuh"

// q, k, v, o: [B, H, N, d] operands with the element strides in
// strides[0..11] (q, k, v, o; each batch, head, sequence). lse: fp32
// [B, H, N], contiguous. D: d padded up to a built head dim. N must be a
// multiple of 128 (checked by the caller). dtype: 0 = fp32 (3xTF32 kernel),
// 1 = bf16 (wgmma kernel). Returns cudaGetLastError().
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                         int H, int N, int d, int D, int dtype, const long long* strides,
                         float scale, void* stream) {
  using namespace flash;
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd_fp32_tf32x3(q, k, v, o, l, B, H, N, d, D, strides, scale, s);
  if (dtype == 1) return launch_fwd_bf16_sm90(q, k, v, o, l, B, H, N, d, D, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}
