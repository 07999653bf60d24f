// Flash attention, backward, dK and dV, fp32, on Hopper's tensor cores, to
// fp32 accuracy. flash_bwd_dkv (flash_bwd.cu) launches this kernel for fp32
// operands.
//
// Replaces the Pallas TPU kernel _flash_attention_dkv_kernel of
// jax/experimental/pallas/ops/tpu/flash_attention.py (launched by
// _flash_attention_bwd_dkv). Same math. For each key row and every query,
// with s = (q . k) * scale recomputed in fp32:
//   p  = exp(s - lse)            dv += p * do
//   dp = do . v                  ds  = (dp - di) * p * scale
//                                dk += ds * q
// summed over all N queries in fp32; dk and dv out in fp32.
//
// Bound on an H100 SXM: 8 B H N^2 d operations (s, dp, dv, dk) against
// 6 B H N d fp32 operands and 2 B H N fp32 rows read or written once
// (32 MB at (B, H, N, d) = (1, 8, 4096, 40), 9.5 us at 3.35 TB/s), so it is
// bound by operations. 3xTF32 (flash_tf32x3.cuh) issues each product three
// times: 3 * 8 B H N^2 d at the dense TF32 rate of 495 TFLOP/s is 260 us at
// (1, 8, 4096, 40) and 33 us at (1, 8, 1024, 80), against 641 / 80 us for
// fp32 FMAs at 67 TFLOP/s. The B H N^2 exponentials add a floor of 32 / 2 us.
//
// Design. mma.sync m16n8k8 with split TF32 operands, as the forward
// (flash_fwd_tf32x3.cu, which says why not wgmma). Key-major: each warp owns
// kMT m-tiles of 16 key rows and computes S^T = K Q^T and dP^T = V dO^T
// with keys as mma's M and queries as its N. Then every product maps onto
// the forward's fragment layout with no data moving between lanes:
// - S^T and dP^T: A is K (or V), read from shared memory in A's fragment
//   order and split (a_frag); B is Q (or dO), B[k = d][n = query], read by
//   b_frag_nk_split from the query tile.
// - P^T and dS^T come out of those accumulators as A fragments by p_frag's
//   permutation: keys g and g + 8, queries 2t and 2t + 1 at k = t and t + 4.
//   P lies in [0, 1] and takes p_frag's split; dS is signed and unbounded,
//   so acc_frag splits it with split<> (lo by cvt.rna), whose
//   reconstruction is within 2^-22 |x| for either sign.
// - dV += P^T dO and dK += dS^T Q: B is dO (or Q) read by b_frag_kn_split
//   in that same permuted query order.
// lse and di are indexed by query, the accumulator's column: each lane reads
// its queries' values (2t and 2t + 1 of each 8-query n-tile) from shared
// memory.
//
// Streaming. The block's kKeys K and V rows are copied to shared memory
// once. Q, dO, lse and di stream through a ring of kStages kQ-query tiles
// filled by cp.async (16-byte copies where the bases, the strides and d
// allow, else 4-byte), so the next tile's copy overlaps this tile's
// products. Every warp reads every Q and dO element of a tile twice (as B
// of S^T or dP^T and of dK or dV), so splitting at each read would cost
// each warp ~7 instructions per element: instead the group's threads split
// each landed tile once, hi in place of the fp32 value and lo into a plane
// beside it, and the warps read both parts with plain loads. Shared rows are
// padded to D + 4 floats, which puts the 32 lanes of every A- and B-fragment
// read on 32 distinct banks.
//
// Registers. A lane keeps its dK and dV accumulators (kMT * D/2 floats
// each) and the S^T and dP^T tiles of one query tile (kMT * kQ/4 floats
// each); K's and V's split fragments (kMT * D words each, too many beside
// those) are read from shared memory and split again on every tile, once
// per 8-deep step for all of the tile's query n-tiles. One 32-query tile is
// one pass of the four products, and with two m-tiles S^T's steps stay
// rolled: otherwise ptxas spilled at D = 40 and 80 (PERF.md).
//
// Accuracy. The tensor cores round each sum toward zero, so each 8-deep step
// of every product is summed in a fresh accumulator and added in fp32
// (mma3_add): dK and dV gather N / 8 such steps each, rounded to nearest.
//
// Grid. Blocks of kKeys keys (kWarps * kMT * 16): at (1, 8, 1024, 80) that
// is 128 blocks for 132 SMs, so at D = 64 and 80 a block runs two query
// groups, each over its own half of the queries with its own ring, and
// group 0 adds group 1's dK and dV partials at the end, in that fixed
// order. Each dK/dV row is written by exactly one block: no atomics, and
// the result repeats bit for bit. The padded columns (d..D-1) of Q, K, V and
// dO are zero, so they add nothing, and nothing is written past d.
//
// PERF.md gives the design variants measured against this kernel on the
// H100 (scripts/flash_variants.py).

#include "flash_common.cuh"
#include "flash_tf32x3.cuh"

namespace flash {
namespace tf32x3 {

template <int D>
struct DkvShape {
  static constexpr int kWarps = 4;  // warps per query group
  // 16-key m-tiles per warp. Two share each Q and dO fragment read, which
  // halves the shared-memory reads per key; past D = 40 their accumulators
  // would not fit in registers.
  static constexpr int kMT = D <= 40 ? 2 : 1;
  static constexpr int kKeys = kWarps * kMT * 16;  // key rows per block
  static constexpr int kQ = 32;                    // queries per Q/dO tile
  static constexpr int kStages = 2;                // Q/dO tiles in flight
  // Query groups per block (see Grid above); at D = 128 two would not fit in
  // shared memory.
  static constexpr int kGroups = D == 64 || D == 80 ? 2 : 1;
  static constexpr bool kHiCvt = false;  // hi by cvt.rna (else by integer rounding)
  // S^T's and dP^T's 8-deep steps unrolled: with two m-tiles, fully
  // unrolled steps spilled (ptxas hoists the next steps' fragments), rolled
  // ones do not and run faster (PERF.md).
  static constexpr int kUnrollS = kMT == 2 ? 1 : D / 8;
  static constexpr int kThreads = kGroups * kWarps * 32;
  static constexpr int kLd = D + 4;              // floats per padded shared row
  static constexpr int kSteps = D / 8;           // k-steps of S^T and dP^T; n-tiles of dK, dV
  static constexpr int kTile = kQ * kLd;         // floats of one Q or dO tile
  static constexpr int kStage = 2 * kTile + 2 * kQ;  // Q, dO, lse and di of one stage
  // One group's floats: its ring, then the lo plane of its current Q and dO.
  static constexpr int kGroup = kStages * kStage + 2 * kTile;
  static constexpr int kKV = 2 * kKeys * kLd;  // the block's K and V rows
  static constexpr size_t kSmemBytes = sizeof(float) * (kKV + kGroups * kGroup);
  static_assert(2 * kQ * D / 4 % (kWarps * 32) == 0, "the split takes whole float4 rounds");
  // Group 1 hands its dK and dV partials (kMT * D floats a lane) over
  // through shared memory.
  static_assert(kGroups == 1 || kMT * D * kWarps * 32 <= kKV + kGroups * kGroup,
                "room for group 1's partials");
};

template <int D>
__global__ void __launch_bounds__(DkvShape<D>::kThreads)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ lse, const float* __restrict__ dout,
           const float* __restrict__ di, float* __restrict__ dk, float* __restrict__ dv, int H,
           int N, int d, Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
           Strides sdv, float scale, int vec) {
  using F = DkvShape<D>;
  constexpr int kLd = F::kLd, kSteps = F::kSteps, kQ = F::kQ, kMT = F::kMT;
  constexpr int kGT = F::kWarps * 32;  // threads per query group
  constexpr int kN = kQ / 8;           // 8-query n-tiles of a tile
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;  // the block's K rows, then its V rows
  float* vs = ks + F::kKeys * kLd;
  const int gr = threadIdx.x / kGT, tid = threadIdx.x % kGT;  // query group, its thread
  float* ring = smem + F::kKV + gr * F::kGroup;
  float* lo_plane = ring + F::kStages * F::kStage;  // lo of the current Q tile, then dO's
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = tid / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int key0 = blockIdx.x * F::kKeys;
  const long long bh = (static_cast<long long>(b) * H + h) * N;
  // This group's query tiles: [tile0, tile0 + tiles).
  const int tiles = N / kQ / F::kGroups, tile0 = gr * tiles;

  // Columns d..D-1 of the K and V rows and of every ring tile stay zero:
  // the copies never write them, and the split turns them into zeros.
  for (int e = threadIdx.x; e < 2 * F::kKeys * (D - d); e += F::kThreads) {
    const int r = e / (D - d);
    ks[r * kLd + d + (e - r * (D - d))] = 0.f;
  }
  for (int e = tid; e < 2 * F::kStages * kQ * (D - d); e += kGT) {
    const int r = e / (D - d), tile = r / kQ;  // tile 2s is stage s's Q, 2s + 1 its dO
    ring[(tile / 2) * F::kStage + (tile % 2) * F::kTile + (r % kQ) * kLd + d +
         (e - r * (D - d))] = 0.f;
  }

  // The block's K and V rows; committed with the group's first tile below.
  {
    const float* kr = k + sk.row(b, h, key0);
    const float* vr = v + sv.row(b, h, key0);
    if (vec) {
      const int groups = d / 4;  // 16-byte column groups of a row
      for (int e = threadIdx.x; e < F::kKeys * groups; e += F::kThreads) {
        const int r = e / groups, c = 4 * (e - r * groups);
        cp_async16(ks + r * kLd + c, kr + r * sk.n + c);
        cp_async16(vs + r * kLd + c, vr + r * sv.n + c);
      }
    } else {
      for (int e = threadIdx.x; e < F::kKeys * d; e += F::kThreads) {
        const int r = e / d, c = e - r * d;
        cp_async4(ks + r * kLd + c, kr + r * sk.n + c);
        cp_async4(vs + r * kLd + c, vr + r * sv.n + c);
      }
    }
  }

  const float* qb = q + sq.row(b, h, 0);
  const float* dob = dout + sdo.row(b, h, 0);
  auto copy_tile = [&](int it) {  // the group's tile number
    float* st = ring + (it % F::kStages) * F::kStage;
    const int m0 = (tile0 + it) * kQ;
    const float* qr = qb + static_cast<long long>(m0) * sq.n;
    const float* dr = dob + static_cast<long long>(m0) * sdo.n;
    if (vec) {
      const int groups = d / 4;
      for (int e = tid; e < kQ * groups; e += kGT) {
        const int r = e / groups, c = 4 * (e - r * groups);
        cp_async16(st + r * kLd + c, qr + r * sq.n + c);
        cp_async16(st + F::kTile + r * kLd + c, dr + r * sdo.n + c);
      }
    } else {
      for (int e = tid; e < kQ * d; e += kGT) {
        const int r = e / d, c = e - r * d;
        cp_async4(st + r * kLd + c, qr + r * sq.n + c);
        cp_async4(st + F::kTile + r * kLd + c, dr + r * sdo.n + c);
      }
    }
    // lse and di rows: contiguous and 16-byte aligned (the wrapper checks).
    if (tid < kQ / 4) {
      cp_async16(st + 2 * F::kTile + 4 * tid, lse + bh + m0 + 4 * tid);
    } else if (tid < kQ / 2) {
      const int i = tid - kQ / 4;
      cp_async16(st + 2 * F::kTile + kQ + 4 * i, di + bh + m0 + 4 * i);
    }
    cp_async_commit();
  };
  copy_tile(0);
  cp_async_wait<0>();
  __syncthreads();  // K, V and both groups' first tiles have landed, the zeros are written

  // dK and dV, m-tile mt, n-tile n: key rows 16 mt + g and 16 mt + g + 8,
  // columns 8n + 2t and 8n + 2t + 1.
  float dka[kMT][kSteps][4], dva[kMT][kSteps][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int n = 0; n < kSteps; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) dka[mt][n][i] = dva[mt][n][i] = 0.f;
  const float* kw = ks + warp * kMT * 16 * kLd;  // this warp's kMT * 16 key rows
  const float* vw = vs + warp * kMT * 16 * kLd;
  const float* qlo = lo_plane;
  const float* dolo = lo_plane + F::kTile;

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      copy_tile(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    group_barrier<kGT>(gr);  // tile it has landed, for every copy of the group's threads
    float* qt = ring + (it % F::kStages) * F::kStage;  // Q's tile, then dO's: hi after the split
    const float* dot = qt + F::kTile;
    const float* lse_t = qt + 2 * F::kTile;
    const float* di_t = lse_t + kQ;

    // Split the Q and dO tiles, four columns a thread at a time (all D: the
    // padded columns are zero and stay so).
#pragma unroll
    for (int i = 0; i < 2 * kQ * D / 4 / kGT; ++i) {
      const int e = tid + i * kGT, r = e / (D / 4), c = 4 * (e - r * (D / 4));
      split4<F::kHiCvt>(reinterpret_cast<float4*>(qt + r * kLd + c),
                        reinterpret_cast<float4*>(lo_plane + r * kLd + c));
    }
    group_barrier<kGT>(gr);  // the split tiles are in place

    // S^T and dP^T, m-tile mt, n-tile j: keys 16 mt + g and + 8, queries
    // 8j + 2t and 8j + 2t + 1.
    float s[kMT][kN][4], dp[kMT][kN][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[mt][j][i] = dp[mt][j][i] = 0.f;
#pragma unroll(F::kUnrollS)
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t kh[kMT][4], kl[kMT][4], vh[kMT][4], vl[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        a_frag<kLd, F::kHiCvt>(kw + mt * 16 * kLd, kk, g, t, kh[mt], kl[mt]);
        a_frag<kLd, F::kHiCvt>(vw + mt * 16 * kLd, kk, g, t, vh[mt], vl[mt]);
      }
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        uint32_t bh[2], bl[2];
        b_frag_nk_split<kLd>(qt, qlo, 8 * j, 8 * kk, g, t, bh, bl);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma3_add(s[mt][j], kh[mt], kl[mt], bh, bl);
        b_frag_nk_split<kLd>(dot, dolo, 8 * j, 8 * kk, g, t, bh, bl);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma3_add(dp[mt][j], vh[mt], vl[mt], bh, bl);
      }
    }

    // P and dS in place of S^T and dP^T.
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + 8 * j + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(di_t + 8 * j + 2 * t);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = expf(s[mt][j][i] * scale - (i & 1 ? l2.y : l2.x));
          s[mt][j][i] = p;
          dp[mt][j][i] = (dp[mt][j][i] - (i & 1 ? d2.y : d2.x)) * p * scale;
        }
    }

    // dV += P^T dO and dK += dS^T Q, query k-step j.
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      uint32_t ph[kMT][4], pl[kMT][4], dh[kMT][4], dl[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        p_frag(s[mt][j], ph[mt], pl[mt]);
        acc_frag<F::kHiCvt>(dp[mt][j], dh[mt], dl[mt]);
      }
#pragma unroll
      for (int n = 0; n < kSteps; ++n) {
        uint32_t bh[2], bl[2];
        b_frag_kn_split<kLd>(dot, dolo, 8 * j, 8 * n, g, t, bh, bl);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma3_add(dva[mt][n], ph[mt], pl[mt], bh, bl);
        b_frag_kn_split<kLd>(qt, qlo, 8 * j, 8 * n, g, t, bh, bl);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma3_add(dka[mt][n], dh[mt], dl[mt], bh, bl);
      }
    }
    group_barrier<kGT>(gr);  // the group is done with this stage and the lo plane
  }

  if constexpr (F::kGroups == 2) {
    // Group 1 hands its dK and dV partials to group 0 through shared memory,
    // lane by lane (the partner lane holds the same rows and columns), once
    // both groups are done with their tiles and K and V; group 0 adds them.
    constexpr int kAcc = kMT * kSteps * 4;  // floats of one lane's dK (or dV)
    float* xs = smem + tid;
    __syncthreads();
    if (gr == 1) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int n = 0; n < kSteps; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int w = (mt * kSteps + n) * 4 + i;
            xs[w * kGT] = dka[mt][n][i];
            xs[(kAcc + w) * kGT] = dva[mt][n][i];
          }
    }
    __syncthreads();
    if (gr == 1) return;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int n = 0; n < kSteps; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int w = (mt * kSteps + n) * 4 + i;
          dka[mt][n][i] += xs[w * kGT];
          dva[mt][n][i] += xs[(kAcc + w) * kGT];
        }
  }

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = key0 + (warp * kMT + mt) * 16 + g + 8 * hf;
      float* ok = dk + sdk.row(b, h, row);
      float* ov = dv + sdv.row(b, h, row);
#pragma unroll
      for (int n = 0; n < kSteps; ++n) {
        const int c = 8 * n + 2 * t;
        if (c < d) {
          ok[c] = dka[mt][n][2 * hf];
          ov[c] = dva[mt][n][2 * hf];
        }
        if (c + 1 < d) {
          ok[c + 1] = dka[mt][n][2 * hf + 1];
          ov[c + 1] = dva[mt][n][2 * hf + 1];
        }
      }
    }
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v, const float* lse,
               const float* dout, const float* di, float* dk, float* dv, int B, int H, int N,
               int d, const long long* strides, float scale, cudaStream_t stream) {
  using F = DkvShape<D>;
  constexpr size_t smem = F::kSmemBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Strides sq = strides_at(strides, 0), sk = strides_at(strides, 1),
                sv = strides_at(strides, 2), sdo = strides_at(strides, 3),
                sdk = strides_at(strides, 4), sdv = strides_at(strides, 5);
  // 16-byte copies need 16-byte aligned rows of every copied operand and
  // whole column groups.
  const int vec = d % 4 == 0 && rows_aligned16(q, sq) && rows_aligned16(k, sk) &&
                  rows_aligned16(v, sv) && rows_aligned16(dout, sdo);
  dkv_kernel<D><<<dim3(N / F::kKeys, H, B), F::kThreads, smem, stream>>>(
      q, k, v, lse, dout, di, dk, dv, H, N, d, sq, sk, sv, sdo, sdk, sdv, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tf32x3

int launch_dkv_fp32_tf32x3(const void* q, const void* k, const void* v, const float* lse,
                           const void* dout, const float* di, void* dk, void* dv, int B, int H,
                           int N, int d, int D, const long long* strides, float scale,
                           cudaStream_t stream) {
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  float* dkp = static_cast<float*>(dk);
  float* dvp = static_cast<float*>(dv);
  switch (D) {
#define FLASH_DKV_TF32X3_CASE(DD)                                                          \
  case DD:                                                                                 \
    return tf32x3::launch_dkv<DD>(qp, kp, vp, lse, dop, di, dkp, dvp, B, H, N, d, strides, \
                                  scale, stream);
    FLASH_HEAD_DIMS(FLASH_DKV_TF32X3_CASE)
#undef FLASH_DKV_TF32X3_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace flash
