// Flash attention, backward dQ, bf16, on Hopper's tensor cores.
// flash_bwd_dq (flash_bwd.cu) launches this kernel for bf16 operands; fp32
// operands run the 3xTF32 kernel of flash_bwd_dq_tf32x3.cu.
//
// Replaces the Pallas TPU kernel _flash_attention_dq_kernel of
// jax/experimental/pallas/ops/tpu/flash_attention.py (launched by
// _flash_attention_bwd_dq). Same math, per query row, over every key:
//   S  = Q K^T (fp32)            P  = exp(S * scale - lse)
//   dP = dO V^T (fp32)           dS = P (dP - di) scale
//   dQ += bf16(dS) K             (fp32 sums, rounded to bf16 once at the end)
// with lse from the forward and di = rowsum(O dO) from the wrapper.
//
// Bound on an H100 SXM, at (B, H, N, d) = (1, 8, 4096, 40): 6 B H N^2 d =
// 32.2 GFLOP of products, 32.6 us at 989 TFLOP/s, against 1.7 MB of
// operands; the B H N^2 = 134M exponentials need at least ~32 us of the
// SFUs (16 a clock per SM) beside them.
//
// Design. The forward kernel's skeleton (flash_fwd_sm90.cu) with one more
// product and no online softmax, since lse is given. A block owns 64 query
// rows per consumer warpgroup (two, or one where two would leave SMs idle)
// of one (batch, head), copies their Q and dO tiles once with TMA, and
// streams K and V through a ring of kStages tiles of kKeys rows, kept full
// by one producer warp with TMA on mbarriers. lse and di are constant per
// query row: each thread reads its two rows' values once. Per key tile,
// each consumer warpgroup runs S = Q K^T and dP = dO V^T as wgmma m64nKk16
// (K = kKeys) from shared memory under one commit, forms P and dS in the
// accumulators' registers (one ex2.approx with scale * log2(e) and
// lse * log2(e) folded into one fmaf), rounds dS to bf16 in place as the A
// operand, and runs dQ += dS K as m64nDk16 with the same K tile read
// MN-major (the no-swizzle layout serves both, flash_sm90.cuh). kKeys = 64
// keeps the live registers (dQ D/2, S and dP kKeys/2 each, bf16 dS kKeys/4)
// under the 168 that 288 threads leave at D = 80 (ptxas: 111 at D = 40,
// 144 at D = 80, no spill). Each dQ row is summed by one warpgroup and
// written once: no atomics, and the result repeats bit for bit. (Measured
// slower on the H100 at (1, 8, 4096, 40): exp2f in place of ex2.approx by
// 5%; 128-key tiles at D = 40, which spill and serialize the wgmma, by 11%;
// 4 stages by 7%; issuing S and dP of the next tile beside this tile's
// dS K, which ptxas serializes (C7513), by 11%.)

#include "flash_sm90.cuh"

namespace flash {
namespace sm90 {

template <int D>
struct DqShape {
  static constexpr int kKeys = 64;  // keys per K/V tile: wgmma's N in S = Q K^T
  static constexpr int kGroups = tile_groups<D>();
  static constexpr int kStages = 3;
  static constexpr int kTileBytes = kKeys * kGroups * 16;
  // K ring, V ring, Q and dO (nc * 64 rows each), then the barriers.
  static size_t smem_bytes(int nc) {
    return 2 * kStages * kTileBytes + 2 * static_cast<size_t>(nc) * kRows * kGroups * 16 +
           (1 + 2 * kStages) * sizeof(uint64_t);
  }
};

template <int D>
__global__ void __launch_bounds__(kMaxThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
          const float* __restrict__ lse, const float* __restrict__ di,
          __nv_bfloat16* __restrict__ dq, int H, int N, int d, Strides sdq, float scale,
          float scale_log2) {
  using F = DqShape<D>;
  constexpr int kKeys = F::kKeys, kGroups = F::kGroups, kStages = F::kStages;
  constexpr int kTileBytes = F::kTileBytes;
  extern __shared__ __align__(1024) uint8_t smem[];
  const int nc = blockDim.x / kWarpgroup;  // consumer warpgroups; the last warp produces
  const int rows = nc * kRows;
  uint8_t* ks = smem;
  uint8_t* vs = ks + kStages * kTileBytes;
  uint8_t* qs = vs + kStages * kTileBytes;
  uint8_t* dos = qs + rows * kGroups * 16;
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(dos + rows * kGroups * 16);
  uint64_t* full = qdo_full + 1;     // tile s holds K and V
  uint64_t* empty = full + kStages;  // every consumer warp is done with tile s
  const int b = blockIdx.z, h = blockIdx.y, m0 = blockIdx.x * rows;
  const int tiles = N / kKeys;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
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
      mbar_expect_tx(qdo_full, 2 * rows * kGroups * 16);
      tma_load_tile(qs, &tq, qdo_full, m0, h, b);
      tma_load_tile(dos, &tdo, qdo_full, m0, h, b);
      produce_kv_ring(ks, vs, &tk, &tv, full, empty, kStages, kTileBytes, kKeys, tiles, h, b);
    }
    return;
  }

  // Consumer warpgroup wg: query rows m0 + 64 wg ... + 63. This thread
  // holds rows r0 and r0 + 8 of them and, in S and dP, the key columns
  // 8 j + c0 + e.
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x % kWarpgroup) / 32 * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint64_t qd = desc_k_major(smem_u32(qs) + wg * kRows * 16, rows);
  const uint64_t dod = desc_k_major(smem_u32(dos) + wg * kRows * 16, rows);
  const long long bh = (static_cast<long long>(b) * H + h) * N;
  float lse_log2[2], di_row[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const long long row = bh + m0 + wg * kRows + r0 + 8 * hf;
    lse_log2[hf] = lse[row] * kLog2e;
    di_row[hf] = di[row];
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(qdo_full, 0);
  for (int t = 0; t < tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(&full[s], (t / kStages) & 1);
    const uint32_t k_tile = smem_u32(ks + s * kTileBytes);
    const uint64_t kd = desc_k_major(k_tile, kKeys);
    const uint64_t vd = desc_k_major(smem_u32(vs + s * kTileBytes), kKeys);

    float sc[kKeys / 2], dp[kKeys / 2];  // S, then P; dP, then dS
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < kGroups / 2; ++i)
      wgmma_ss<kKeys>(sc, qd + k_step(i, rows), kd + k_step(i, kKeys), i);
#pragma unroll
    for (int i = 0; i < kGroups / 2; ++i)
      wgmma_ss<kKeys>(dp, dod + k_step(i, rows), vd + k_step(i, kKeys), i);
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);
    pin(dp);

#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hf + e;
          const float p = fast_exp2(fmaf(sc[i], scale_log2, -lse_log2[hf]));
          dp[i] = (dp[i] - di_row[hf]) * p * scale;
        }
    uint32_t dsa[kKeys / 16][4];  // bf16 dS as the A operand of dS K
#pragma unroll
    for (int i = 0; i < kKeys / 16; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) dsa[i][r] = pack_bf16(dp[8 * i + 2 * r], dp[8 * i + 2 * r + 1]);
    pin(acc);
    pin(dsa);
    wgmma_fence();
    const uint64_t km = desc_mn_major(k_tile, kKeys);
#pragma unroll
    for (int i = 0; i < kKeys / 16; ++i) wgmma_rs<D>(acc, dsa[i], km + mn_step(i));
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = m0 + wg * kRows + r0 + 8 * hf;
    __nv_bfloat16* out = dq + sdq.row(b, h, row);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j < d)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + c0) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const float* lse, const void* dout,
              const float* di, void* dq, int B, int H, int N, int d, const long long* strides,
              float scale, cudaStream_t stream) {
  using F = DqShape<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(F::smem_bytes(kMaxConsumers)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int nc = consumers_for(B, H, N);
  CUtensorMap tq, tk, tv, tdo;
  int err = make_tile_map(&tq, q, B, H, N, d, strides_at(strides, 0), nc * kRows, F::kGroups);
  if (!err) err = make_tile_map(&tk, k, B, H, N, d, strides_at(strides, 1), F::kKeys, F::kGroups);
  if (!err) err = make_tile_map(&tv, v, B, H, N, d, strides_at(strides, 2), F::kKeys, F::kGroups);
  if (!err)
    err = make_tile_map(&tdo, dout, B, H, N, d, strides_at(strides, 3), nc * kRows, F::kGroups);
  if (err) return err;
  dq_kernel<D><<<dim3(N / (nc * kRows), H, B), nc * kWarpgroup + 32, F::smem_bytes(nc), stream>>>(
      tq, tk, tv, tdo, lse, di, static_cast<__nv_bfloat16*>(dq), H, N, d, strides_at(strides, 4),
      scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90

int launch_dq_bf16_sm90(const void* q, const void* k, const void* v, const float* lse,
                        const void* dout, const float* di, void* dq, int B, int H, int N, int d,
                        int D, const long long* strides, float scale, cudaStream_t stream) {
  switch (D) {
#define FLASH_DQ_SM90_CASE(DD) \
  case DD:                     \
    return sm90::launch_dq<DD>(q, k, v, lse, dout, di, dq, B, H, N, d, strides, scale, stream);
    FLASH_HEAD_DIMS(FLASH_DQ_SM90_CASE)
#undef FLASH_DQ_SM90_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace flash
