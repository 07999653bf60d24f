// Flash attention, forward, bf16, on Hopper's tensor cores: O = softmax(Q
// K^T * scale) V and lse = m + log(l) per row. flash_fwd (flash_fwd.cu)
// launches this kernel for bf16 operands, and the 3xTF32 kernel of
// flash_fwd_tf32x3.cu for fp32 operands.
//
// Replaces the Pallas TPU kernel _flash_attention_kernel of
// jax/experimental/pallas/ops/tpu/flash_attention.py (launched by
// _flash_attention_impl), which the SD UNet calls at
// siss_tpu/models/unet2d_cond.py:155-158. Same math: logits fp32 (bf16
// products summed in fp32), a running row max m and row sum l over key
// tiles, l summed from P before P is rounded to bf16 for P V, unnormalised;
// O summed in fp32 and divided by l at the end.
//
// Bound on an H100 SXM, at the SD shape (B, H, N, d) = (1, 8, 4096, 40):
// 4 B H N^2 d = 21.5 GFLOP of products, 21.7 us at 989 TFLOP/s, against
// 1.4 MB of operands. At a head dim this small the B H N^2 = 134M
// exponentials weigh as much: the SFUs do 16 a clock per SM, ~4.2e12/s on
// 132 SMs, so at least ~32 us.
//
// Design. A block owns 64 query rows per consumer warpgroup (two, or one
// where two would leave SMs idle; flash_sm90.cuh consumers_for) of one
// (batch, head) and streams K and V through a ring of kStages shared-memory
// tiles of kKeys rows. One producer warp keeps the ring full with TMA copies
// (a 5-D tensor map writes each tile straight into wgmma's layout, the
// padded k-depth zero-filled) and mbarriers; the consumers never wait for
// a copy that the ring could have started earlier. Per key tile, each
// consumer warpgroup runs S = Q K^T as wgmma m64n128k16 from shared memory,
// the online softmax in registers (exp2f, scale * log2(e) folded into one
// fmaf), and O += P V as m64nDk16 with P, rounded to bf16, as the A operand
// straight from the S accumulator's registers. The two consumer warpgroups
// work on the same tiles at their own pace, so one's softmax runs under the
// other's products. (Measured slower on the H100: strict ping-pong turns on
// named barriers with the previous tile's P V issued beside this tile's
// Q K^T, by 19-22%, as ptxas serializes the conditional wgmma; and a
// one-instruction ex2.approx in place of exp2f, by 3%.) No atomics: the
// result repeats bit for bit.

#include "flash_sm90.cuh"

namespace flash {
namespace sm90 {

constexpr int kKeys = 128;  // keys per K/V tile: wgmma's N in S = Q K^T

template <int D>
struct FwdShape {
  static constexpr int kGroups = tile_groups<D>();
  static constexpr int kStages = D <= 80 ? 3 : 2;
  static constexpr int kTileBytes = kKeys * kGroups * 16;
  // K ring, V ring, Q (nc * 64 rows), then the barriers.
  static size_t smem_bytes(int nc) {
    return 2 * kStages * kTileBytes + static_cast<size_t>(nc) * kRows * kGroups * 16 +
           (1 + 2 * kStages) * sizeof(uint64_t);
  }
};

template <int D>
__global__ void __launch_bounds__(kMaxThreads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
           float* __restrict__ lse, int H, int N, int d, Strides so, float scale_log2) {
  using F = FwdShape<D>;
  constexpr int kGroups = F::kGroups, kStages = F::kStages, kTileBytes = F::kTileBytes;
  extern __shared__ __align__(1024) uint8_t smem[];
  const int nc = blockDim.x / kWarpgroup;  // consumer warpgroups; the last warp produces
  const int rows = nc * kRows;
  uint8_t* ks = smem;
  uint8_t* vs = ks + kStages * kTileBytes;
  uint8_t* qs = vs + kStages * kTileBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(qs + rows * kGroups * 16);
  uint64_t* full = q_full + 1;      // tile s holds K and V
  uint64_t* empty = full + kStages;  // every consumer warp is done with tile s
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * rows;
  const int tiles = N / kKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * nc);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWarpgroup;
  if (wg == nc) {  // producer warp: one lane issues every copy
    if (threadIdx.x == nc * kWarpgroup) {
      mbar_expect_tx(q_full, rows * kGroups * 16);
      tma_load_tile(qs, &tq, q_full, m0, h, b);
      produce_kv_ring(ks, vs, &tk, &tv, full, empty, kStages, kTileBytes, kKeys, tiles, h, b);
    }
    return;
  }

  // Consumer warpgroup wg: query rows m0 + 64 wg ... + 63. This thread
  // holds rows r0 and r0 + 8 of them (see the accumulator layout).
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x % kWarpgroup) / 32 * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint64_t qd = desc_k_major(smem_u32(qs) + wg * kRows * 16, rows);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // row max of S * scale * log2(e)
  float l[2] = {0.f, 0.f};                      // this thread's part of the row sum

  mbar_wait(q_full, 0);
  for (int t = 0; t < tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(&full[s], (t / kStages) & 1);
    const uint64_t kd = desc_k_major(smem_u32(ks + s * kTileBytes), kKeys);
    const uint64_t vd = desc_mn_major(smem_u32(vs + s * kTileBytes), kKeys);

    float sc[kKeys / 2];
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < kGroups / 2; ++i)
      wgmma_ss<kKeys>(sc, qd + k_step(i, rows), kd + k_step(i, kKeys), i);
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hf], sc[4 * j + 2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hf], mx * scale_log2);
      const float alpha = exp2f(m[hf] - m_new);  // 0 on the first tile, where m = -inf
      float p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * hf + e];
          x = exp2f(fmaf(x, scale_log2, -m_new));
          p_sum += x;
        }
      l[hf] = l[hf] * alpha + p_sum;
      m[hf] = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 2 * hf] *= alpha;
        acc[4 * j + 2 * hf + 1] *= alpha;
      }
    }

    uint32_t pa[kKeys / 16][4];  // P in bf16 as the A operand of P V
#pragma unroll
    for (int i = 0; i < kKeys / 16; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[i][r] = pack_bf16(sc[8 * i + 2 * r], sc[8 * i + 2 * r + 1]);
    pin(acc);
    pin(pa);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < kKeys / 16; ++i) wgmma_rs<D>(acc, pa[i], vd + mn_step(i));
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float sum = l[hf];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = m0 + wg * kRows + r0 + 8 * hf;
    __nv_bfloat16* out = o + so.row(b, h, row);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j < d)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + c0) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hf] / sum, acc[4 * j + 2 * hf + 1] / sum);
    if (lane % 4 == 0)
      lse[(static_cast<long long>(b) * H + h) * N + row] = (m[hf] + log2f(sum)) * kLn2;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int N,
           int d, const long long* strides, float scale, cudaStream_t stream) {
  using F = FwdShape<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(F::smem_bytes(kMaxConsumers)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int nc = consumers_for(B, H, N);
  CUtensorMap tq, tk, tv;
  int err = make_tile_map(&tq, q, B, H, N, d, strides_at(strides, 0), nc * kRows, F::kGroups);
  if (!err) err = make_tile_map(&tk, k, B, H, N, d, strides_at(strides, 1), kKeys, F::kGroups);
  if (!err) err = make_tile_map(&tv, v, B, H, N, d, strides_at(strides, 2), kKeys, F::kGroups);
  if (err) return err;
  fwd_kernel<D><<<dim3(N / (nc * kRows), H, B), nc * kWarpgroup + 32, F::smem_bytes(nc), stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, H, N, d, strides_at(strides, 3),
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90

int launch_fwd_bf16_sm90(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                         int H, int N, int d, int D, const long long* strides, float scale,
                         cudaStream_t stream) {
  switch (D) {
#define FLASH_FWD_SM90_CASE(DD) \
  case DD:                      \
    return sm90::launch<DD>(q, k, v, o, lse, B, H, N, d, strides, scale, stream);
    FLASH_HEAD_DIMS(FLASH_FWD_SM90_CASE)
#undef FLASH_FWD_SM90_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace flash
