// Flash attention, backward, dQ, fp32, on Hopper's tensor cores, to fp32
// accuracy. flash_bwd_dq (flash_bwd.cu) launches this kernel for fp32
// operands.
//
// Replaces the Pallas TPU kernel _flash_attention_dq_kernel of
// jax/experimental/pallas/ops/tpu/flash_attention.py (launched by
// _flash_attention_bwd_dq). Same math. For each query row and every key,
// with s = (q . k) * scale recomputed in fp32:
//   p  = exp(s - lse)            ds  = (dp - di) * p * scale
//   dp = do . v                  dq += ds * k
// summed over all N keys in fp32; dq out in fp32.
//
// Bound on an H100 SXM: 6 B H N^2 d operations (s, dp, dq) against
// 5 B H N d fp32 operands and 2 B H N fp32 rows read or written once
// (26 MB at (B, H, N, d) = (1, 8, 4096, 40), 7.8 us at 3.35 TB/s), so it is
// bound by operations. 3xTF32 (flash_tf32x3.cuh) issues each product three
// times: 3 * 6 B H N^2 d at the dense TF32 rate of 495 TFLOP/s is 195 us at
// (1, 8, 4096, 40) and 24 us at (1, 8, 1024, 80), against 481 / 60 us for
// fp32 FMAs at 67 TFLOP/s. The B H N^2 exponentials add a floor of 32 / 2 us.
//
// Design. mma.sync m16n8k8 with split TF32 operands, as the forward
// (flash_fwd_tf32x3.cu, which says why not wgmma), on the forward's
// skeleton with K in V's place. Query-major: each warp owns kMT m-tiles of
// 16 query rows, kWarps warps a key group, and every product maps onto the
// forward's fragment layout with no data moving between lanes:
// - S = Q K^T and dP = dO V^T: A is Q (or dO), split once before the key
//   loop and kept for all of it; B is K (or V) read as B[k = d][n = key]
//   by b_frag_nk_split.
// - dS comes out of those accumulators as an A fragment by acc_frag (keys
//   2t and 2t + 1 at k = t and t + 4); dS is signed and unbounded, so its lo
//   is rounded by cvt.rna, within 2^-22 |x| for either sign.
// - dQ += dS K: B is K read as B[k = key][n = d] by b_frag_kn_split in that
//   same permuted key order.
// lse and di are indexed by query, the accumulator's row: each lane reads
// those of its rows g and g + 8 once.
//
// Streaming. K and V stream through a ring of kStages kKeys-key tiles
// filled by cp.async (16-byte copies where the bases, the strides and d
// allow, else 4-byte), so the next tile's copy overlaps this tile's
// products. Every warp reads every K element twice (as B of S and of dQ)
// and every V element once, so the group's threads split each landed tile
// once, hi in place of the fp32 value and lo into a plane beside it, and
// the warps read both parts with plain loads (in the dK/dV kernel this
// took 1.20 to 0.93 ms on the H100; PERF.md). Shared rows are padded to
// D + 4 floats, which puts the 32 lanes of every B-fragment read on 32
// distinct banks.
//
// Registers. A lane keeps its dQ accumulators (kMT * D/2 floats) and the S
// and dP tiles of one key tile (kMT * kKeys/2 floats each) across a tile,
// so a tile is 32 keys: at D = 40 with two m-tiles a 64-key tile's S and
// dP alone would take 128 registers. Q's and dO's split fragments (four
// parts of kMT * D/2 words: Q hi, dO hi, Q lo, dO lo) stay in registers
// only at D <= 16 (and Q's hi part at D = 128); elsewhere all four live in
// lane-private shared memory, one 16-byte load per fragment. With Q's hi
// part in registers ptxas spilled at D = 40 and 80, and with none there it
// used 181 / 137 registers in the same time (PERF.md). Shared memory then
// holds 113 KB a block at D = 40, so two blocks take all 228 KB of an SM.
//
// Accuracy. The tensor cores round each sum toward zero, so each 8-deep step
// of every product is summed in a fresh accumulator and added in fp32
// (mma3_add): dQ gathers N / 8 such steps, rounded to nearest.
//
// Grid. Blocks of kRows queries (kWarps * kMT * 16): at (1, 8, 1024, 80)
// that is 128 blocks for 132 SMs, so at D = 64 and 80 a block runs two key
// groups, each over its own half of the keys with its own ring, and group 0
// adds group 1's dQ partial at the end, in that fixed order. Both groups
// hold the same query rows and so share one copy of the split Q and dO
// fragments. Each dQ row is written by exactly one block: no atomics, and
// the result repeats bit for bit. No softmax rescaling: lse is known, so
// partials simply add. The padded columns (d..D-1) of Q, K, V and dO are
// zero, so they add nothing, and nothing is written past d.
//
// PERF.md gives the design variants measured against this kernel on the
// H100 (scripts/flash_variants.py).

#include <type_traits>

#include "flash_common.cuh"
#include "flash_tf32x3.cuh"

namespace flash {
namespace tf32x3 {

template <int D>
struct DqShape {
  static constexpr int kWarps = 4;  // warps per key group
  // 16-row m-tiles per warp. Two share each K and V fragment read, which
  // halves the shared-memory reads per row; past D = 40 their registers
  // would not fit.
  static constexpr int kMT = D <= 40 ? 2 : 1;
  static constexpr int kRows = kWarps * kMT * 16;  // query rows per block
  static constexpr int kKeys = 32;                 // keys per K/V tile
  static constexpr int kStages = 2;                // K/V tiles in flight
  // Key groups per block (see Grid above); at D = 128 two rings would not
  // fit in shared memory.
  static constexpr int kGroups = D == 64 || D == 80 ? 2 : 1;
  static constexpr bool kHiCvt = false;  // hi by cvt.rna (else by integer rounding)
  // Parts of Q's and dO's split fragments (Q hi, dO hi, Q lo, dO lo, in that
  // order) kept in registers; the others live in shared memory (see
  // Registers above). At D = 128 all four would not fit in shared memory.
  static constexpr int kRegParts = D <= 16 ? 4 : D == 128 ? 1 : 0;
  static constexpr int kThreads = kGroups * kWarps * 32;
  static constexpr int kLd = D + 4;       // floats per padded shared row
  static constexpr int kSteps = D / 8;    // k-steps of S and dP; n-tiles of dQ
  static constexpr int kN = kKeys / 8;    // key n-tiles of S and dP; k-steps of dQ
  static constexpr int kTile = kKeys * kLd;    // floats of one K or V tile
  // One group's floats: its ring (K then V tile of each stage), then the lo
  // plane of its current K and V tiles.
  static constexpr int kGroup = kStages * 2 * kTile + 2 * kTile;
  // One warp's fragments of one part in shared memory: a uint4 a lane for
  // each (m-tile, k-step).
  static constexpr int kPart = kMT * kSteps * 32 * 4;
  static constexpr int kFrags = kWarps * (4 - kRegParts) * kPart;  // shared by the groups
  static constexpr size_t kSmemBytes = sizeof(float) * (kGroups * kGroup + kFrags);
  static_assert(2 * kKeys * D / 4 % (kWarps * 32) == 0, "the split takes whole float4 rounds");
  // Group 1 hands its dQ partial (kMT * D/2 floats a lane) over through its
  // own ring.
  static_assert(kMT * D / 2 * kWarps * 32 <= kGroup, "room for group 1's partial");
};

template <int D>
__global__ void __launch_bounds__(DqShape<D>::kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ lse, const float* __restrict__ dout,
          const float* __restrict__ di, float* __restrict__ dq, int H, int N, int d, Strides sq,
          Strides sk, Strides sv, Strides sdo, Strides sdq, float scale, int vec) {
  using F = DqShape<D>;
  constexpr int kLd = F::kLd, kSteps = F::kSteps, kMT = F::kMT, kN = F::kN;
  constexpr int kKeys = F::kKeys, kStages = F::kStages, kTile = F::kTile;
  constexpr int kRegParts = F::kRegParts;
  constexpr int kGT = F::kWarps * 32;  // threads per key group
  extern __shared__ __align__(16) float smem[];
  const int gr = threadIdx.x / kGT, tid = threadIdx.x % kGT;  // key group, its thread
  float* ring = smem + gr * F::kGroup;
  float* lo_plane = ring + kStages * 2 * kTile;  // lo of the current K tile, then V's
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = tid / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // This warp's m-tile mt holds query rows r0 + 16 mt + g and r0 + 16 mt + g + 8.
  const int r0 = blockIdx.x * F::kRows + warp * kMT * 16;
  const long long bh = (static_cast<long long>(b) * H + h) * N;
  // This group's key tiles: [tile0, tile0 + tiles).
  const int tiles = N / kKeys / F::kGroups, tile0 = gr * tiles;

  // Columns d..D-1 of every ring tile stay zero: the copies never write
  // them, and the split turns them into zeros.
  for (int e = tid; e < 2 * kStages * kKeys * (D - d); e += kGT) {
    const int r = e / (D - d);
    ring[r * kLd + d + (e - r * (D - d))] = 0.f;
  }

  const float* kb = k + sk.row(b, h, 0);
  const float* vb = v + sv.row(b, h, 0);
  auto copy_tile = [&](int it) {  // the group's tile number
    float* kd = ring + (it % kStages) * 2 * kTile;
    float* vd = kd + kTile;
    const long long n0 = static_cast<long long>(tile0 + it) * kKeys;
    const float* kr = kb + n0 * sk.n;
    const float* vr = vb + n0 * sv.n;
    if (vec) {
      const int groups = d / 4;  // 16-byte column groups of a row
      for (int e = tid; e < kKeys * groups; e += kGT) {
        const int r = e / groups, c = 4 * (e - r * groups);
        cp_async16(kd + r * kLd + c, kr + r * sk.n + c);
        cp_async16(vd + r * kLd + c, vr + r * sv.n + c);
      }
    } else {
      for (int e = tid; e < kKeys * d; e += kGT) {
        const int r = e / d, c = e - r * d;
        cp_async4(kd + r * kLd + c, kr + r * sk.n + c);
        cp_async4(vd + r * kLd + c, vr + r * sv.n + c);
      }
    }
    cp_async_commit();
  };
  copy_tile(0);

  // Q's and dO's A fragments for S = Q K^T and dP = dO V^T, split once:
  // part p of (m-tile mt, k-step kk) in registers for p < kRegParts, else in
  // this lane's own uint4 of shared memory (so no barrier; both key groups
  // write the same values to the same words).
  uint32_t regs[kRegParts ? kRegParts : 1][kMT][kSteps][4];  // unused where kRegParts = 0
  uint4* frags = reinterpret_cast<uint4*>(smem + F::kGroups * F::kGroup) +
                 warp * (4 - kRegParts) * kMT * kSteps * 32 + lane;
  auto slot = [&](int p, int mt, int kk) -> uint4& {
    return frags[((p - kRegParts) * kMT + mt) * kSteps * 32 + kk * 32];
  };
  float lse_r[kMT][2], di_r[kMT][2];  // rows g and g + 8 of each m-tile
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r0 + mt * 16 + g + 8 * hf;
      lse_r[mt][hf] = lse[bh + row];
      di_r[mt][hf] = di[bh + row];
    }
#pragma unroll
    for (int op = 0; op < 2; ++op) {  // Q, then dO
      const float* x0 = op ? dout + sdo.row(b, h, r0 + mt * 16 + g)
                           : q + sq.row(b, h, r0 + mt * 16 + g);
      const long long down = 8 * (op ? sdo.n : sq.n);  // row g + 8
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const int c = 8 * kk + t;
        const float x[4] = {c < d ? x0[c] : 0.f, c < d ? x0[down + c] : 0.f,
                            c + 4 < d ? x0[c + 4] : 0.f, c + 4 < d ? x0[down + c + 4] : 0.f};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split<F::kHiCvt>(x[i], hi[i], lo[i]);
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // hi parts 0 and 1, lo parts 2 and 3
          const int p = 2 * half + op;
          const uint32_t* w = half ? lo : hi;
          if (p < kRegParts) {
#pragma unroll
            for (int i = 0; i < 4; ++i) regs[p < kRegParts ? p : 0][mt][kk][i] = w[i];
          } else {
            slot(p, mt, kk) = make_uint4(w[0], w[1], w[2], w[3]);
          }
        }
      }
    }
  }
  // Part P's fragment of (mt, kk); P a compile-time constant.
  auto frag = [&](auto part, int mt, int kk, uint32_t(&a)[4]) {
    constexpr int P = decltype(part)::value;
    if constexpr (P < kRegParts) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = regs[P][mt][kk][i];
    } else {
      const uint4 x = slot(P, mt, kk);
      a[0] = x.x;
      a[1] = x.y;
      a[2] = x.z;
      a[3] = x.w;
    }
  };
  using QHi = std::integral_constant<int, 0>;
  using DoHi = std::integral_constant<int, 1>;
  using QLo = std::integral_constant<int, 2>;
  using DoLo = std::integral_constant<int, 3>;

  // dQ, m-tile mt, n-tile n: rows g and g + 8, columns 8n + 2t and 8n + 2t + 1.
  float dqa[kMT][kSteps][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int n = 0; n < kSteps; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) dqa[mt][n][i] = 0.f;
  const float* klo = lo_plane;
  const float* vlo = lo_plane + kTile;

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      copy_tile(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    group_barrier<kGT>(gr);  // tile it has landed, for every copy of the group's threads
    float* kt = ring + (it % kStages) * 2 * kTile;  // K's tile, then V's: hi after the split
    const float* vt = kt + kTile;

    // Split the K and V tiles, four columns a thread at a time (all D: the
    // padded columns are zero and stay so).
#pragma unroll
    for (int i = 0; i < 2 * kKeys * D / 4 / kGT; ++i) {
      const int e = tid + i * kGT, r = e / (D / 4), c = 4 * (e - r * (D / 4));
      split4<F::kHiCvt>(reinterpret_cast<float4*>(kt + r * kLd + c),
                        reinterpret_cast<float4*>(lo_plane + r * kLd + c));
    }
    group_barrier<kGT>(gr);  // the split tiles are in place

    // S and dP, m-tile mt, n-tile j: rows g and g + 8, keys 8j + 2t and
    // 8j + 2t + 1.
    float s[kMT][kN][4], dp[kMT][kN][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[mt][j][i] = dp[mt][j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        frag(QHi{}, mt, kk, ah[mt]);
        frag(QLo{}, mt, kk, al[mt]);
      }
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        uint32_t bh[2], bl[2];
        b_frag_nk_split<kLd>(kt, klo, 8 * j, 8 * kk, g, t, bh, bl);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma3_add(s[mt][j], ah[mt], al[mt], bh, bl);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        frag(DoHi{}, mt, kk, ah[mt]);
        frag(DoLo{}, mt, kk, al[mt]);
      }
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        uint32_t bh[2], bl[2];
        b_frag_nk_split<kLd>(vt, vlo, 8 * j, 8 * kk, g, t, bh, bl);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma3_add(dp[mt][j], ah[mt], al[mt], bh, bl);
      }
    }

    // dS in place of dP: accumulator element i is row g + 8 (i / 2).
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = expf(s[mt][j][i] * scale - lse_r[mt][i / 2]);
          dp[mt][j][i] = (dp[mt][j][i] - di_r[mt][i / 2]) * p * scale;
        }

    // dQ += dS K, key k-step j.
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) acc_frag<F::kHiCvt>(dp[mt][j], ah[mt], al[mt]);
#pragma unroll
      for (int n = 0; n < kSteps; ++n) {
        uint32_t bh[2], bl[2];
        b_frag_kn_split<kLd>(kt, klo, 8 * j, 8 * n, g, t, bh, bl);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma3_add(dqa[mt][n], ah[mt], al[mt], bh, bl);
      }
    }
    group_barrier<kGT>(gr);  // the group is done with this stage and the lo plane
  }

  if constexpr (F::kGroups == 2) {
    // Group 1 hands its dQ partial to group 0 through its own ring, lane by
    // lane (the partner lane holds the same rows and columns); group 0 adds
    // it.
    if (gr == 1) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int n = 0; n < kSteps; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) ring[((mt * kSteps + n) * 4 + i) * kGT + tid] = dqa[mt][n][i];
    }
    __syncthreads();
    if (gr == 1) return;
    const float* xs = smem + F::kGroup + tid;  // group 1's ring
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int n = 0; n < kSteps; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) dqa[mt][n][i] += xs[((mt * kSteps + n) * 4 + i) * kGT];
  }

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float* out = dq + sdq.row(b, h, r0 + mt * 16 + g + 8 * hf);
#pragma unroll
      for (int n = 0; n < kSteps; ++n) {
        const int c = 8 * n + 2 * t;
        if (c < d) out[c] = dqa[mt][n][2 * hf];
        if (c + 1 < d) out[c + 1] = dqa[mt][n][2 * hf + 1];
      }
    }
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v, const float* lse,
              const float* dout, const float* di, float* dq, int B, int H, int N, int d,
              const long long* strides, float scale, cudaStream_t stream) {
  using F = DqShape<D>;
  constexpr size_t smem = F::kSmemBytes;
  // All of an SM's shared memory for shared memory (not L1): at D = 40 two
  // blocks need it.
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Strides sq = strides_at(strides, 0), sk = strides_at(strides, 1),
                sv = strides_at(strides, 2), sdo = strides_at(strides, 3),
                sdq = strides_at(strides, 4);
  // 16-byte copies need 16-byte aligned K and V rows and whole column groups.
  const int vec = d % 4 == 0 && rows_aligned16(k, sk) && rows_aligned16(v, sv);
  dq_kernel<D><<<dim3(N / F::kRows, H, B), F::kThreads, smem, stream>>>(
      q, k, v, lse, dout, di, dq, H, N, d, sq, sk, sv, sdo, sdq, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tf32x3

int launch_dq_fp32_tf32x3(const void* q, const void* k, const void* v, const float* lse,
                          const void* dout, const float* di, void* dq, int B, int H, int N,
                          int d, int D, const long long* strides, float scale,
                          cudaStream_t stream) {
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  float* dqp = static_cast<float*>(dq);
  switch (D) {
#define FLASH_DQ_TF32X3_CASE(DD)                                                                \
  case DD:                                                                                      \
    return tf32x3::launch_dq<DD>(qp, kp, vp, lse, dop, di, dqp, B, H, N, d, strides, scale, \
                                 stream);
    FLASH_HEAD_DIMS(FLASH_DQ_TF32X3_CASE)
#undef FLASH_DQ_TF32X3_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace flash
