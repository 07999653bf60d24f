// Flash attention, forward, fp32, on Hopper's tensor cores: O = softmax(Q
// K^T * scale) V and lse = m + log(l) per row, to fp32 accuracy. flash_fwd
// (flash_fwd.cu) launches this kernel for fp32 operands.
//
// Replaces the Pallas TPU kernel _flash_attention_kernel of
// jax/experimental/pallas/ops/tpu/flash_attention.py (launched by
// _flash_attention_impl), which the SD UNet calls at
// siss_tpu/models/unet2d_cond.py:155-158. Same math: fp32 logits, a running
// row max m and row sum l over key tiles, O = P V accumulated in fp32 and
// divided by l at the end, lse = m + log(l).
//
// Bound on an H100 SXM: 4 B H N^2 d operations against 4 B H N d fp32
// operands read or written once (21 MB at (B, H, N, d) = (1, 8, 4096, 40),
// 6 us at 3.35 TB/s), so it is bound by operations. Plain TF32 keeps ~3
// decimal digits and breaks fp32 parity; 3xTF32 (flash_tf32x3.cuh) issues
// each product three times, so the bound is 3 * 4 B H N^2 d at the dense TF32
// rate of 495 TFLOP/s: 130 us at (1, 8, 4096, 40) and 16 us at
// (1, 8, 1024, 80), against 320 / 40 us for fp32 FMAs at 67 TFLOP/s. The
// B H N^2 exponentials add a floor of 32 / 2 us on the SFUs.
//
// Design. mma.sync m16n8k8, not wgmma: wgmma takes TF32 operands from shared
// memory only K-major, and V ([keys, d], contracted over keys) is MN-major,
// so wgmma would need a transposed copy of V, and hi and lo copies of every
// tile with a descriptor each. mma.sync takes its fragments from registers,
// loaded from any shared address, so V is read where it lies and the split
// happens in registers. Each warp owns kMT m-tiles of 16 query rows of one
// (batch, head), kWarps warps a key group; at D <= 40 two m-tiles share
// every split K and V fragment, halving that work per row. At D = 64 and 80
// a block runs two key groups over the two halves of the keys and merges
// them, so the SD UNet's thin N = 1024 grid keeps two warps per scheduler.
// Q's fragments are split once and kept in registers, or in lane-private
// shared memory where registers would spill. K and V stream through a ring
// of kStages 64-key tiles filled by cp.async (16-byte copies where the base,
// the strides and d allow, else 4-byte), so the next tile's copy overlaps
// this tile's products. Shared rows are padded to D + 4 floats, which puts
// the 32 lanes of every B-fragment read on 32 distinct banks. Per tile:
// S = Q K^T (three mma.sync per 16 x 8 x 8 block), the online softmax in
// registers (row max and row sum over the 4 lanes of a quad by shuffles;
// expf, as the fp32 plain version's accuracy asks), then O += P V with P
// taken straight from S's accumulator registers (p_frag). As the tensor
// cores round their sums toward zero, each 8-deep step of S, and of P V
// (at D = 64 and 80, each key tile's P V), is summed in a fresh accumulator
// and added in fp32. The padded columns of Q, K and V are zero, so they add
// nothing. No atomics: the result repeats bit for bit.
//
// PERF.md gives the design variants measured against this kernel on the
// H100 (scripts/flash_variants.py), the choices below among them.

#include "flash_common.cuh"
#include "flash_tf32x3.cuh"

namespace flash {
namespace tf32x3 {

constexpr int kKeys = 64;      // keys per K/V tile
constexpr int kStages = 2;     // K/V tiles in flight
constexpr int kWarpRows = 16;  // query rows of one m-tile: mma's M
constexpr int kWarps = 4;      // warps per key group

template <int D>
struct FwdShape {
  // 16-row m-tiles per warp. Two share each split K and V fragment, which
  // halves the split and shared-memory work per row; past D = 40 their Q
  // and accumulator registers would not fit.
  static constexpr int kMT = D <= 40 ? 2 : 1;
  // Key groups per block: each holds the block's query rows and runs over
  // its own half of the keys, and the halves merge at the end. At D = 64 and
  // 80 (the SD UNet's N = 1024 sites, 128 blocks for 132 SMs) this doubles
  // the warps an SM has to hide latency with; at D = 128 its rings would
  // not fit in shared memory.
  static constexpr int kGroups = D == 64 || D == 80 ? 2 : 1;
  // O += P V per key tile: each 8-deep step added to O in fp32 (mma3_add),
  // or, where there are registers for it, the tile's 8 steps summed in one
  // fresh accumulator by the tensor core (mma3) and added to O once: 24
  // roundings toward zero at the tile's scale, within 2x the fp32 plain
  // version's float64 error and faster at the (1, 8, 1024, 80) SD sites
  // (PERF.md).
  static constexpr bool kPvPerTile = kGroups == 2;
  static constexpr int kThreads = kGroups * kWarps * 32;
  static constexpr int kRows = kWarps * kMT * kWarpRows;  // query rows per block
  static constexpr int kLd = D + 4;          // floats per padded shared row
  static constexpr int kSteps = D / 8;       // k-steps of Q K^T; n-tiles of P V
  // Where Q's split fragments live: registers, or lane-private shared memory
  // where registers would spill. ptxas spilled (H100 build, PERF.md) once the
  // words a lane keeps across the key loop (O and S accumulators, kCore,
  // plus Q's parts held in registers) passed ~140: so Q's hi parts stay in
  // registers at D <= 16 and 64, its lo parts at D <= 16.
  static constexpr int kCore = kMT * ((kPvPerTile ? D : D / 2) + kKeys / 2);
  static constexpr bool kQHiInRegs = kCore + kMT * D / 2 <= 140;
  static constexpr bool kQLoInRegs = kCore + kMT * D <= 140;
  static constexpr bool kQInSmem = !kQHiInRegs || !kQLoInRegs;
  // Operands' hi parts rounded by cvt.rna (four instructions) at D = 80, by
  // integer operations on the bits (two) elsewhere: with the latter, ptxas
  // spilled there, and the ways out cost more (S's k-steps unrolled by 2:
  // 12% slower than cvt on the H100, PERF.md).
  static constexpr bool kHiCvt = D == 80;
  static constexpr int kTile = kKeys * kLd;  // floats per K or V tile
  static constexpr int kQWords = kMT * kSteps * 8 * 32;  // one warp's split Q fragments
  static constexpr int kRing = 2 * kStages * kTile;  // floats of one group's K and V ring
  static constexpr size_t kSmemBytes =
      sizeof(float) * (kGroups * kRing + (kQInSmem ? kWarps * kQWords : 0));
};

template <int D>
__global__ void __launch_bounds__(FwdShape<D>::kThreads)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           float* __restrict__ o, float* __restrict__ lse, int H, int N, int d, Strides sq,
           Strides sk, Strides sv, Strides so, float scale, int vec) {
  using F = FwdShape<D>;
  constexpr int kLd = F::kLd, kSteps = F::kSteps, kMT = F::kMT, kThreads = kWarps * 32;
  extern __shared__ __align__(16) float smem[];
  const int gr = threadIdx.x / kThreads, tid = threadIdx.x % kThreads;  // key group, its thread
  float* ks = smem + gr * F::kRing;  // this group's kStages K tiles, then kStages V tiles
  float* vs = ks + kStages * F::kTile;
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = tid / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // This warp's m-tile mt holds query rows r0 + 16 mt + g and r0 + 16 mt + g + 8.
  const int r0 = blockIdx.x * F::kRows + warp * kMT * kWarpRows;
  const float* kb = k + sk.row(b, h, 0);
  const float* vb = v + sv.row(b, h, 0);
  // This group's key tiles: [tile0, tile0 + tiles).
  const int tiles = N / kKeys / F::kGroups, tile0 = gr * tiles;

  // Columns d..D-1 of every ring tile stay zero: the copies never write them.
  for (int e = tid; e < 2 * kStages * kKeys * (D - d); e += kThreads) {
    const int r = e / (D - d);
    ks[r * kLd + d + (e - r * (D - d))] = 0.f;
  }

  auto copy_tile = [&](int tile) {  // the group's tile number
    float* kd = ks + (tile % kStages) * F::kTile;
    float* vd = vs + (tile % kStages) * F::kTile;
    const float* kr = kb + static_cast<long long>(tile0 + tile) * kKeys * sk.n;
    const float* vr = vb + static_cast<long long>(tile0 + tile) * kKeys * sv.n;
    if (vec) {
      const int groups = d / 4;  // 16-byte column groups of a row
      for (int e = tid; e < kKeys * groups; e += kThreads) {
        const int r = e / groups, c = 4 * (e - r * groups);
        cp_async16(kd + r * kLd + c, kr + r * sk.n + c);
        cp_async16(vd + r * kLd + c, vr + r * sv.n + c);
      }
    } else {
      for (int e = tid; e < kKeys * d; e += kThreads) {
        const int r = e / d, c = e - r * d;
        cp_async4(kd + r * kLd + c, kr + r * sk.n + c);
        cp_async4(vd + r * kLd + c, vr + r * sv.n + c);
      }
    }
    cp_async_commit();
  };
  copy_tile(0);

  // Q's A fragments for S = Q K^T, split once. In shared memory, each lane
  // reads back only its own words (so no barrier): hi in words 0..3 of an
  // (m-tile, k-step) slot, lo in 4..7.
  uint32_t qhi[F::kQHiInRegs ? kMT : 1][F::kQHiInRegs ? kSteps : 1][4];
  uint32_t qlo[F::kQLoInRegs ? kMT : 1][F::kQLoInRegs ? kSteps : 1][4];
  uint32_t* qsm =
      reinterpret_cast<uint32_t*>(smem + F::kGroups * F::kRing) + warp * F::kQWords + lane;
  auto qslot = [&](int mt, int kk, int w) -> uint32_t& {
    return qsm[((mt * kSteps + kk) * 8 + w) * 32];
  };
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const float* q0 = q + sq.row(b, h, r0 + mt * kWarpRows + g);
    const float* q1 = q + sq.row(b, h, r0 + mt * kWarpRows + g + 8);
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int c = 8 * kk + t;
      const float x[4] = {c < d ? q0[c] : 0.f, c < d ? q1[c] : 0.f, c + 4 < d ? q0[c + 4] : 0.f,
                          c + 4 < d ? q1[c + 4] : 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t hi, lo;
        split<F::kHiCvt>(x[i], hi, lo);
        if constexpr (F::kQHiInRegs) qhi[mt][kk][i] = hi; else qslot(mt, kk, i) = hi;
        if constexpr (F::kQLoInRegs) qlo[mt][kk][i] = lo; else qslot(mt, kk, 4 + i) = lo;
      }
    }
  }
  auto q_frag = [&](int mt, int kk, uint32_t(&ah)[4], uint32_t(&al)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (F::kQHiInRegs) ah[i] = qhi[mt][kk][i]; else ah[i] = qslot(mt, kk, i);
      if constexpr (F::kQLoInRegs) al[i] = qlo[mt][kk][i]; else al[i] = qslot(mt, kk, 4 + i);
    }
  };

  // O, m-tile mt, n-tile n: rows g and g + 8, columns 8n + 2t and 8n + 2t + 1.
  float acc[kMT][kSteps][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int n = 0; n < kSteps; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][n][i] = 0.f;
  float m[kMT][2], l[kMT][2];  // row max of S * scale; this lane's part of the row sum
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      m[mt][hf] = -CUDART_INF_F;
      l[mt][hf] = 0.f;
    }

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      copy_tile(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    group_barrier<kThreads>(gr);  // tile it has landed, for every copy of the group's threads
    const float* kt = ks + (it % kStages) * F::kTile;
    const float* vt = vs + (it % kStages) * F::kTile;

    float s[kMT][kKeys / 8][4];  // S, n-tile j: keys 8j + 2t and 8j + 2t + 1
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[mt][j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) q_frag(mt, kk, ah[mt], al[mt]);
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        uint32_t bh[2], bl[2];
        b_frag_nk<kLd, F::kHiCvt>(kt, 8 * j, 8 * kk, g, t, bh, bl);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma3_add(s[mt][j], ah[mt], al[mt], bh, bl);
      }
    }

#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[mt][j][2 * hf + e] *= scale;
            mx = fmaxf(mx, s[mt][j][2 * hf + e]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][hf], mx);
        const float alpha = expf(m[mt][hf] - m_new);  // 0 on the first tile, where m = -inf
        float p_sum = 0.f;
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[mt][j][2 * hf + e];
            x = expf(x - m_new);
            p_sum += x;
          }
        l[mt][hf] = l[mt][hf] * alpha + p_sum;
        m[mt][hf] = m_new;
#pragma unroll
        for (int n = 0; n < kSteps; ++n) {
          acc[mt][n][2 * hf] *= alpha;
          acc[mt][n][2 * hf + 1] *= alpha;
        }
      }

    float pv[F::kPvPerTile ? kMT : 1][F::kPvPerTile ? kSteps : 1][4] = {};
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) p_frag(s[mt][j], ah[mt], al[mt]);
#pragma unroll
      for (int n = 0; n < kSteps; ++n) {
        uint32_t bh[2], bl[2];
        b_frag_kn<kLd, F::kHiCvt>(vt, 8 * j, 8 * n, g, t, bh, bl);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          if constexpr (F::kPvPerTile) mma3(pv[mt][n], ah[mt], al[mt], bh, bl);
          else mma3_add(acc[mt][n], ah[mt], al[mt], bh, bl);
        }
      }
    }
    if constexpr (F::kPvPerTile) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int n = 0; n < kSteps; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][n][i] += pv[mt][n][i];
    }
    group_barrier<kThreads>(gr);  // every warp of the group is done with this stage before it is refilled
  }

  if constexpr (F::kGroups == 2) {
    // Group 1 hands its m, l and O to group 0 through its own ring (lane by
    // lane: the partner lane holds the same rows and columns), and group 0
    // merges them: m = max(m0, m1), then l and O as l0 e^(m0 - m) + l1
    // e^(m1 - m), as the online softmax rescales between tiles.
    float* xs = ks + tid;
    constexpr int kAcc = kMT * kSteps * 4;
    if (gr == 1) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int n = 0; n < kSteps; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) xs[((mt * kSteps + n) * 4 + i) * kThreads] = acc[mt][n][i];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          xs[(kAcc + mt * 4 + hf) * kThreads] = m[mt][hf];
          xs[(kAcc + mt * 4 + 2 + hf) * kThreads] = l[mt][hf];
        }
      }
    }
    __syncthreads();
    if (gr == 1) return;
    xs = smem + F::kRing + tid;  // group 1's ring
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float m1 = xs[(kAcc + mt * 4 + hf) * kThreads];
        const float l1 = xs[(kAcc + mt * 4 + 2 + hf) * kThreads];
        const float m_new = fmaxf(m[mt][hf], m1);
        const float a0 = expf(m[mt][hf] - m_new), a1 = expf(m1 - m_new);
        l[mt][hf] = l[mt][hf] * a0 + l1 * a1;
        m[mt][hf] = m_new;
#pragma unroll
        for (int n = 0; n < kSteps; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = acc[mt][n][2 * hf + e];
            x = x * a0 + xs[((mt * kSteps + n) * 4 + 2 * hf + e) * kThreads] * a1;
          }
      }
  }

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float sum = l[mt][hf];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int row = r0 + mt * kWarpRows + g + 8 * hf;
      float* out = o + so.row(b, h, row);
#pragma unroll
      for (int n = 0; n < kSteps; ++n) {
        const int c = 8 * n + 2 * t;
        if (c < d) out[c] = acc[mt][n][2 * hf] / sum;
        if (c + 1 < d) out[c + 1] = acc[mt][n][2 * hf + 1] / sum;
      }
      if (t == 0) lse[(static_cast<long long>(b) * H + h) * N + row] = m[mt][hf] + logf(sum);
    }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, float* lse, int B, int H,
           int N, int d, const long long* strides, float scale, cudaStream_t stream) {
  using F = FwdShape<D>;
  constexpr size_t smem = F::kSmemBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Strides sq = strides_at(strides, 0), sk = strides_at(strides, 1),
                sv = strides_at(strides, 2), so = strides_at(strides, 3);
  // 16-byte copies need 16-byte aligned K and V rows and whole column groups.
  const int vec = d % 4 == 0 && rows_aligned16(k, sk) && rows_aligned16(v, sv);
  fwd_kernel<D><<<dim3(N / F::kRows, H, B), F::kThreads, smem, stream>>>(
      q, k, v, o, lse, H, N, d, sq, sk, sv, so, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tf32x3

int launch_fwd_fp32_tf32x3(const void* q, const void* k, const void* v, void* o, float* lse,
                           int B, int H, int N, int d, int D, const long long* strides,
                           float scale, cudaStream_t stream) {
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(o);
  switch (D) {
#define FLASH_FWD_TF32X3_CASE(DD) \
  case DD:                        \
    return tf32x3::launch<DD>(qp, kp, vp, op, lse, B, H, N, d, strides, scale, stream);
    FLASH_HEAD_DIMS(FLASH_FWD_TF32X3_CASE)
#undef FLASH_FWD_TF32X3_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace flash
