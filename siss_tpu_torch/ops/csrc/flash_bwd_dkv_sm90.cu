// Flash attention, backward dK and dV, bf16, on Hopper's tensor cores.
// flash_bwd_dkv (flash_bwd.cu) launches this kernel for bf16 operands; fp32
// operands run the 3xTF32 kernel of flash_bwd_dkv_tf32x3.cu.
//
// Replaces the Pallas TPU kernel _flash_attention_dkv_kernel of
// jax/experimental/pallas/ops/tpu/flash_attention.py (launched by
// _flash_attention_bwd_dkv). Same math, per key row, over every query:
//   S^T = K Q^T (fp32)           P^T = exp(S^T * scale - lse)
//   dV += bf16(P^T) dO           dP^T = V dO^T
//   dS^T = P^T (dP^T - di) scale dK += bf16(dS^T) Q
// with lse from the forward and di = rowsum(O dO) from the wrapper.
//
// Bound on an H100 SXM, at (B, H, N, d) = (1, 8, 4096, 40): 8 B H N^2 d =
// 43.0 GFLOP of products, 43.4 us at 989 TFLOP/s, against 2.2 MB of
// operands; the B H N^2 = 134M exponentials need at least ~32 us of the
// SFUs (16 a clock per SM) beside them.
//
// Design. A block owns 64 key rows per consumer warpgroup (two, or one
// where two would leave SMs idle) of one (batch, head), holds their K and V
// tiles in shared memory, and streams Q, dO, lse and di through a ring of
// kStages tiles of kQueries rows, kept full by one producer warp with TMA
// (Q, dO) and bulk copies (lse, di) on mbarriers. Per query tile, each
// consumer warpgroup runs S^T = K Q^T and dP^T = V dO^T as wgmma
// m64n64k16 with both operands in shared memory, forms P^T and dS^T in the
// accumulators' registers (one ex2.approx, 7% faster here than exp2f, with
// scale * log2(e) folded into one fmaf), and rounds them to bf16 in place as the A operands of dV += P^T dO
// and dK += dS^T Q (m64nDk16, Q and dO read MN-major from the same tiles).
// Each dK and dV row is summed by one warpgroup and written once: no
// atomics, and the result repeats bit for bit.

#include "flash_sm90.cuh"

namespace flash {
namespace sm90 {

constexpr int kQueries = 64;  // queries per Q/dO tile: wgmma's N in S^T = K Q^T

template <int D>
struct DkvShape {
  static constexpr int kGroups = tile_groups<D>();
  static constexpr int kStages = 3;
  static constexpr int kTileBytes = kQueries * kGroups * 16;
  static constexpr int kRowBytes = kQueries * sizeof(float);  // lse or di of one tile
  // Q ring, dO ring, lse ring, di ring, K and V (nc * 64 rows each), barriers.
  static size_t smem_bytes(int nc) {
    return kStages * (2 * kTileBytes + 2 * kRowBytes) +
           2 * static_cast<size_t>(nc) * kRows * kGroups * 16 +
           (1 + 2 * kStages) * sizeof(uint64_t);
  }
};

template <int D>
__global__ void __launch_bounds__(kMaxThreads, 1)
dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
           const float* __restrict__ lse, const float* __restrict__ di,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H, int N, int d,
           Strides sdk, Strides sdv, float scale, float scale_log2) {
  using F = DkvShape<D>;
  constexpr int kGroups = F::kGroups, kStages = F::kStages, kTileBytes = F::kTileBytes;
  constexpr int kRowBytes = F::kRowBytes;
  extern __shared__ __align__(1024) uint8_t smem[];
  const int nc = blockDim.x / kWarpgroup;  // consumer warpgroups; the last warp produces
  const int keys = nc * kRows;
  uint8_t* qs = smem;
  uint8_t* dos = qs + kStages * kTileBytes;
  float* lse_s = reinterpret_cast<float*>(dos + kStages * kTileBytes);
  float* di_s = lse_s + kStages * kQueries;
  uint8_t* ks = reinterpret_cast<uint8_t*>(di_s + kStages * kQueries);
  uint8_t* vs = ks + keys * kGroups * 16;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(vs + keys * kGroups * 16);
  uint64_t* full = kv_full + 1;      // tile s holds Q, dO, lse and di
  uint64_t* empty = full + kStages;  // every consumer warp is done with tile s
  const int b = blockIdx.z, h = blockIdx.y, n0 = blockIdx.x * keys;
  const long long bh = (static_cast<long long>(b) * H + h) * N;
  const int tiles = N / kQueries;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
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
      mbar_expect_tx(kv_full, 2 * keys * kGroups * 16);
      tma_load_tile(ks, &tk, kv_full, n0, h, b);
      tma_load_tile(vs, &tv, kv_full, n0, h, b);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(&empty[s], (t / kStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * kTileBytes + 2 * kRowBytes);
        tma_load_tile(qs + s * kTileBytes, &tq, &full[s], t * kQueries, h, b);
        tma_load_tile(dos + s * kTileBytes, &tdo, &full[s], t * kQueries, h, b);
        bulk_load(lse_s + s * kQueries, lse + bh + t * kQueries, kRowBytes, &full[s]);
        bulk_load(di_s + s * kQueries, di + bh + t * kQueries, kRowBytes, &full[s]);
      }
    }
    return;
  }

  // Consumer warpgroup wg: key rows n0 + 64 wg ... + 63. This thread holds
  // rows r0 and r0 + 8 of them and, in S^T, the query columns 8 j + c0 + e.
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x % kWarpgroup) / 32 * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint64_t kd = desc_k_major(smem_u32(ks) + wg * kRows * 16, keys);
  const uint64_t vd = desc_k_major(smem_u32(vs) + wg * kRows * 16, keys);

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int t = 0; t < tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(&full[s], (t / kStages) & 1);
    const uint32_t q_tile = smem_u32(qs + s * kTileBytes), do_tile = smem_u32(dos + s * kTileBytes);
    const uint64_t qk = desc_k_major(q_tile, kQueries), dok = desc_k_major(do_tile, kQueries);

    float st[kQueries / 2], dpt[kQueries / 2];  // S^T, then P^T; dP^T, then dS^T
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < kGroups / 2; ++i)
      wgmma_ss<kQueries>(st, kd + k_step(i, keys), qk + k_step(i, kQueries), i);
#pragma unroll
    for (int i = 0; i < kGroups / 2; ++i)
      wgmma_ss<kQueries>(dpt, vd + k_step(i, keys), dok + k_step(i, kQueries), i);
    wgmma_commit();
    wgmma_wait_all();
    pin(st);
    pin(dpt);

    const float* ls = lse_s + s * kQueries;
    const float* ds = di_s + s * kQueries;
#pragma unroll
    for (int j = 0; j < kQueries / 8; ++j) {
      const float2 lse2 = *reinterpret_cast<const float2*>(ls + 8 * j + c0);
      const float2 di2 = *reinterpret_cast<const float2*>(ds + 8 * j + c0);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float lse_log2 = (e ? lse2.y : lse2.x) * kLog2e;
        const float di_col = e ? di2.y : di2.x;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 4 * j + 2 * hf + e;
          const float p = fast_exp2(fmaf(st[i], scale_log2, -lse_log2));
          dpt[i] = (dpt[i] - di_col) * p * scale;
          st[i] = p;
        }
      }
    }
    uint32_t pa[kQueries / 16][4], dsa[kQueries / 16][4];  // bf16 P^T and dS^T as A operands
#pragma unroll
    for (int i = 0; i < kQueries / 16; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[i][r] = pack_bf16(st[8 * i + 2 * r], st[8 * i + 2 * r + 1]);
        dsa[i][r] = pack_bf16(dpt[8 * i + 2 * r], dpt[8 * i + 2 * r + 1]);
      }
    pin(dv_acc);
    pin(dk_acc);
    pin(pa);
    pin(dsa);
    wgmma_fence();
    const uint64_t dom = desc_mn_major(do_tile, kQueries), qm = desc_mn_major(q_tile, kQueries);
#pragma unroll
    for (int i = 0; i < kQueries / 16; ++i) wgmma_rs<D>(dv_acc, pa[i], dom + mn_step(i));
#pragma unroll
    for (int i = 0; i < kQueries / 16; ++i) wgmma_rs<D>(dk_acc, dsa[i], qm + mn_step(i));
    wgmma_commit();
    wgmma_wait_all();
    pin(dv_acc);
    pin(dk_acc);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = n0 + wg * kRows + r0 + 8 * hf;
    __nv_bfloat16* dk_row = dk + sdk.row(b, h, row);
    __nv_bfloat16* dv_row = dv + sdv.row(b, h, row);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j < d) {
        const int i = 4 * j + 2 * hf;
        *reinterpret_cast<__nv_bfloat162*>(dk_row + 8 * j + c0) =
            __floats2bfloat162_rn(dk_acc[i], dk_acc[i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv_row + 8 * j + c0) =
            __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
      }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const float* lse, const void* dout,
           const float* di, void* dk, void* dv, int B, int H, int N, int d,
           const long long* strides, float scale, cudaStream_t stream) {
  using F = DkvShape<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(F::smem_bytes(kMaxConsumers)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int nc = consumers_for(B, H, N);
  CUtensorMap tq, tk, tv, tdo;
  int err = make_tile_map(&tq, q, B, H, N, d, strides_at(strides, 0), kQueries, F::kGroups);
  if (!err) err = make_tile_map(&tk, k, B, H, N, d, strides_at(strides, 1), nc * kRows, F::kGroups);
  if (!err) err = make_tile_map(&tv, v, B, H, N, d, strides_at(strides, 2), nc * kRows, F::kGroups);
  if (!err)
    err = make_tile_map(&tdo, dout, B, H, N, d, strides_at(strides, 3), kQueries, F::kGroups);
  if (err) return err;
  dkv_kernel<D><<<dim3(N / (nc * kRows), H, B), nc * kWarpgroup + 32, F::smem_bytes(nc), stream>>>(
      tq, tk, tv, tdo, lse, di, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      H, N, d, strides_at(strides, 4), strides_at(strides, 5), scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90

int launch_dkv_bf16_sm90(const void* q, const void* k, const void* v, const float* lse,
                         const void* dout, const float* di, void* dk, void* dv, int B, int H,
                         int N, int d, int D, const long long* strides, float scale,
                         cudaStream_t stream) {
  switch (D) {
#define FLASH_DKV_SM90_CASE(DD) \
  case DD:                      \
    return sm90::launch<DD>(q, k, v, lse, dout, di, dk, dv, B, H, N, d, strides, scale, stream);
    FLASH_HEAD_DIMS(FLASH_DKV_SM90_CASE)
#undef FLASH_DKV_SM90_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace flash
