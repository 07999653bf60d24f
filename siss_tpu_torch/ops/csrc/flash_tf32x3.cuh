// Pieces of the fp32 flash-attention forward, dK/dV and dQ on Hopper's
// tensor cores (flash_fwd_tf32x3.cu, flash_bwd_dkv_tf32x3.cu,
// flash_bwd_dq_tf32x3.cu): the three-product TF32 split ("3xTF32") that
// keeps fp32 accuracy on the tensor cores, mma.sync m16n8k8 with TF32
// operands, its fragment loaders for row-padded shared-memory tiles, the
// split of a landed tile in place, cp.async and named barriers.
//
// The split. A tensor core reads a TF32 operand: the top 19 bits of a
// 32-bit register (sign, 8 exponent bits, 10 mantissa bits). An fp32 x is
// split into hi = rna(x), the nearest TF32 value with ties away from zero
// (as cvt.rna.tf32.f32 rounds), and lo = rna(x - hi); x - hi is exact in
// fp32, and |x - hi - lo| <= 2^-22 |x|. A product a b is then formed as
// lo_a hi_b + hi_a lo_b + hi_a hi_b, small terms first, each exact in the
// fp32 accumulator (11 by 11 significant bits); the dropped lo_a lo_b and the
// two roundings of lo leave at most ~3 * 2^-22 |a| |b| (mma3_add says how the
// sums are kept to fp32 accuracy too). Without the rounding a tensor core
// would truncate x to its top 19 bits, and hi would carry a one-sided error
// of up to 2^-10 |x|. ops/flash_attention.py split_tf32 forms hi and lo bit
// for bit as split() does.
//
// Fragments of mma.sync.m16n8k8 with TF32 operands (PTX ISA), for lane
// g * 4 + t of a warp: A (16 x 8, row major) a0 = (g, t), a1 = (g + 8, t),
// a2 = (g, t + 4), a3 = (g + 8, t + 4); B (8 x 8, k by n) b0 = (t, g),
// b1 = (t + 4, g); C (16 x 8) c0 = (g, 2t), c1 = (g, 2t + 1), c2 = (g + 8, 2t),
// c3 = (g + 8, 2t + 1).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace flash {
namespace tf32x3 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The nearest TF32 value to x, ties away from zero, as a 32-bit pattern.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// The same rounding by integer operations on x's bits: add half a TF32 ulp
// to the magnitude, clear the low 13 bits. The same bits as cvt.rna for every
// x but NaN, in two instructions where cvt takes four; a NaN whose
// mantissa's top bits are all set carries into the sign and comes out
// finite.
__device__ __forceinline__ uint32_t to_tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo to within 2^-22 |x|, both TF32. hi by to_tf32_bits (or, with
// kHiCvt, by cvt.rna: the same bits but for NaN), lo by cvt.rna: for a NaN
// x, x - hi is NaN whatever hi is, and cvt keeps it, so the products stay
// NaN; an infinite x gives hi = x and lo = NaN.
template <bool kHiCvt>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = kHiCvt ? to_tf32(x) : to_tf32_bits(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// Four floats at x split into hi (in place) and lo: a streamed tile split
// once by the threads of a block, then read by every warp with plain loads.
template <bool kHiCvt>
__device__ __forceinline__ void split4(float4* x, float4* lo) {
  float v[4] = {x->x, x->y, x->z, x->w};
  uint32_t hb[4], lb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split<kHiCvt>(v[i], hb[i], lb[i]);
  *x = make_float4(__uint_as_float(hb[0]), __uint_as_float(hb[1]), __uint_as_float(hb[2]),
                   __uint_as_float(hb[3]));
  *lo = make_float4(__uint_as_float(lb[0]), __uint_as_float(lb[1]), __uint_as_float(lb[2]),
                    __uint_as_float(lb[3]));
}

// d += a b: one m16n8k8 product with TF32 operands and an fp32 accumulator.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b from the split operands, accumulated in d by the tensor core: lo
// hi, hi lo, then hi hi, small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
}

// d += a b to fp32 accuracy: the three products go into a zeroed accumulator,
// which is then added to d in fp32. A tensor core rounds each product's sum
// toward zero, to d's scale when it accumulates into d: a running sum over N
// keys would collect ~3N/8 such roundings, all of one sign (measured on the
// H100: 10x the fp32 plain version's error at N = 4096). This way each 8-deep
// step is rounded toward zero once, at its own scale, and d is summed with
// round-to-nearest as in fp32 FMA code.
__device__ __forceinline__ void mma3_add(float (&d)[4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                         const uint32_t (&bl)[2]) {
  float step[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(step, ah, al, bh, bl);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += step[i];
}

// The split B fragment of rows n0..n0+7 of a [rows, LD] tile read as B[k][n] =
// tile[n0 + n][k0 + k]: K in S = Q K^T, k running over the head dim.
template <int LD, bool kHiCvt>
__device__ __forceinline__ void b_frag_nk(const float* __restrict__ tile, int n0, int k0, int g,
                                          int t, uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  const float* p = tile + (n0 + g) * LD + k0 + t;
  split<kHiCvt>(p[0], bh[0], bl[0]);
  split<kHiCvt>(p[4], bh[1], bl[1]);
}

// The split B fragment of a [rows, LD] tile read as B[k][n] = tile[k0 + k'][n0 + n]
// with the k order permuted to k' = 2t, 2t + 1 for k = t, t + 4: V in O += P V,
// k running over keys in the order the S accumulator hands P over (see
// p_frag).
template <int LD, bool kHiCvt>
__device__ __forceinline__ void b_frag_kn(const float* __restrict__ tile, int k0, int n0, int g,
                                          int t, uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  const float* p = tile + (k0 + 2 * t) * LD + n0 + g;
  split<kHiCvt>(p[0], bh[0], bl[0]);
  split<kHiCvt>(p[LD], bh[1], bl[1]);
}

// The same two fragments from a tile already split into a hi and a lo plane
// of the same layout: no arithmetic, two loads per part.
template <int LD>
__device__ __forceinline__ void b_frag_nk_split(const float* __restrict__ hi,
                                                const float* __restrict__ lo, int n0, int k0,
                                                int g, int t, uint32_t (&bh)[2],
                                                uint32_t (&bl)[2]) {
  const int i = (n0 + g) * LD + k0 + t;
  bh[0] = __float_as_uint(hi[i]);
  bh[1] = __float_as_uint(hi[i + 4]);
  bl[0] = __float_as_uint(lo[i]);
  bl[1] = __float_as_uint(lo[i + 4]);
}
template <int LD>
__device__ __forceinline__ void b_frag_kn_split(const float* __restrict__ hi,
                                                const float* __restrict__ lo, int k0, int n0,
                                                int g, int t, uint32_t (&bh)[2],
                                                uint32_t (&bl)[2]) {
  const int i = (k0 + 2 * t) * LD + n0 + g;
  bh[0] = __float_as_uint(hi[i]);
  bh[1] = __float_as_uint(hi[i + LD]);
  bl[0] = __float_as_uint(lo[i]);
  bl[1] = __float_as_uint(lo[i + LD]);
}

// The split A fragment of rows 0..15 of a [rows, LD] tile, k-step kk:
// a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4): K in
// S^T = K Q^T, k running over the head dim.
template <int LD, bool kHiCvt>
__device__ __forceinline__ void a_frag(const float* __restrict__ rows, int kk, int g, int t,
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const float* p = rows + g * LD + 8 * kk + t;
  split<kHiCvt>(p[0], ah[0], al[0]);
  split<kHiCvt>(p[8 * LD], ah[1], al[1]);
  split<kHiCvt>(p[4], ah[2], al[2]);
  split<kHiCvt>(p[8 * LD + 4], ah[3], al[3]);
}

// The split A fragment of P from an S accumulator tile c (keys k0 + 2t and
// k0 + 2t + 1 of rows g and g + 8): a0 = c0, a1 = c2, a2 = c1, a3 = c3, which
// is keys 2t, 2t + 1 at k = t, t + 4, the order b_frag_kn reads V in. No data
// moves between lanes. P lies in [0, 1], and both its parts take
// to_tf32_bits: a NaN P (from a NaN logit) is also summed into the row sum
// l, which makes the row's output NaN whatever its split.
__device__ __forceinline__ void p_frag(const float (&c)[4], uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  const int order[4] = {0, 2, 1, 3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = c[order[i]];
    ah[i] = to_tf32_bits(x);
    al[i] = to_tf32_bits(x - __uint_as_float(ah[i]));
  }
}

// The same A fragment of a signed, unbounded accumulator tile (dS^T in the
// dK/dV kernel): lo by cvt.rna (split<>), so |x - hi - lo| <= 2^-22 |x| for
// either sign and a NaN stays NaN.
template <bool kHiCvt>
__device__ __forceinline__ void acc_frag(const float (&c)[4], uint32_t (&ah)[4],
                                         uint32_t (&al)[4]) {
  const int order[4] = {0, 2, 1, 3};
#pragma unroll
  for (int i = 0; i < 4; ++i) split<kHiCvt>(c[order[i]], ah[i], al[i]);
}

// Asynchronous copies global -> shared: 16 bytes (.cg, through L2 only; both
// addresses 16-byte aligned) or 4 bytes (.ca, the only size below 16 that an
// unaligned fp32 view allows).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until at most n of this thread's committed copy groups are pending.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(n) : "memory");
}

// Barrier over the kCount threads of group gr of a block (named barrier
// gr + 1; barrier 0 is __syncthreads').
template <int kCount>
__device__ __forceinline__ void group_barrier(int gr) {
  asm volatile("bar.sync %0, %1;" ::"r"(gr + 1), "n"(kCount) : "memory");
}

// Whether an operand's rows can be copied in 16-byte pieces: a 16-byte
// aligned base and batch, head and sequence strides of whole float4s.
inline bool rows_aligned16(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 4 == 0 && s.h % 4 == 0 &&
         s.n % 4 == 0;
}

}  // namespace tf32x3
}  // namespace flash
