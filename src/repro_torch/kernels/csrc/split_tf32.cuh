// fp32 products on the tensor cores with split TF32 ("3xTF32"), shared by
// the fp32 attention forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu).
//
// A TF32 operand keeps 10 of fp32's 23 mantissa bits, about three digits.
// The split writes each fp32 value as hi + lo, both TF32: hi is x rounded to
// TF32 (to nearest, ties away from zero: add half a TF32 ulp to the bits and
// clear the 13 low ones, as cvt.rna.tf32.f32 does), lo is x - hi (exact in
// fp32) rounded the same way.  Then
//
//     a.b ~ hi_a.hi_b + hi_a.lo_b + lo_a.hi_b,
//
// three mma.sync.m16n8k8 TF32 products; the dropped lo_a.lo_b and the
// rounding of lo are ~2^-22 of the product, an fp32 rounding.  The tensor
// cores add inside one mma with truncation (biased toward zero), so no sum
// stays on them long: a score product (over the head dim) folds each
// k-step's three products into fp32 registers with an ordinary
// (round-to-nearest) add, and a product over keys or q rows chains its big
// and its small products apart over one tile's k-steps and folds both when
// the tile ends.  The CPU tests mirror this arithmetic
// (tests/test_torch_attention_split_tf32.py).
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4): A (16 x 8, rows x k)
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8,
// k x cols) b0 (t, g), b1 (t + 4, g); C (16 x 8) c0, c1 (g, 2t, 2t + 1),
// c2, c3 (g + 8, 2t, 2t + 1).  An operand stored [rows][k] with k
// contiguous (row pitch a multiple of 16 bytes) loads with one
// ldmatrix.x4 per A fragment or per two B fragments: ldmatrix hands lane l
// the 32-bit word l % 4 of row l / 4 of each 8 x 4-word matrix, which is
// the TF32 layout.  A C tile becomes the A operand of the next product
// with its k index permuted, k = t <-> column 2t and k = t + 4 <-> column
// 2t + 1 (a = {c0, c2, c1, c3}); the B operand then reads rows 2t and
// 2t + 1 of its 8-row k step (c_operand_b).
#pragma once

#include "mbarrier.cuh"

#include <stdint.h>

// x rounded to TF32, to nearest with ties away from zero, as fp32 bits
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32: hi rounded, lo = x - hi (exact in fp32) rounded
// (<= 2^-22 of x is lost; truncating lo instead doubles that, which shows
// in the attention's error against float64)
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - __uint_as_float(hi));
}

template <int N>
__device__ __forceinline__ void tf32_split(const uint32_t* x, uint32_t* hi,
                                           uint32_t* lo) {
#pragma unroll
  for (int i = 0; i < N; ++i) tf32_split(__uint_as_float(x[i]), hi[i], lo[i]);
}

// d += a . b, one TF32 m16n8k8 product with an fp32 accumulator
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a . b in split TF32: big += hi_a . hi_b, small += hi_a . lo_b +
// lo_a . hi_b.  Two chains that the caller adds once they end (the small
// one is ~2^-11 of the big one, so its own truncation is lost in the sum),
// or, with big == small, one chain of the three.
__device__ __forceinline__ void mma_split(float* big, float* small,
                                          const uint32_t* ahi,
                                          const uint32_t* alo,
                                          const uint32_t* bhi,
                                          const uint32_t* blo) {
  mma_tf32(small, alo, bhi);
  mma_tf32(small, ahi, blo);
  mma_tf32(big, ahi, bhi);
}

// four 8 x 4-word matrices from shared memory; lane l names row l % 8 of
// matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// The A fragment of rows [r0, r0 + 16), k columns [k0, k0 + 8) of a
// [rows][k] tile with row pitch ld floats, split.
__device__ __forceinline__ void load_a_split(const float* tile, int ld,
                                             int r0, int k0, uint32_t* hi,
                                             uint32_t* lo) {
  const int lane = threadIdx.x & 31;
  uint32_t a[4];
  ldmatrix_x4(a, tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + k0 +
                     (lane >> 4) * 4);
  tf32_split<4>(a, hi, lo);
}

// The B fragments of two 8-column tiles, columns [n0, n0 + 16) and k
// [k0, k0 + 8), of an operand stored [columns][k] with row pitch ld floats,
// split: hi[0..1] / lo[0..1] the first tile's, [2..3] the second's.
__device__ __forceinline__ void load_b2_split(const float* tile, int ld,
                                              int n0, int k0, uint32_t* hi,
                                              uint32_t* lo) {
  const int lane = threadIdx.x & 31;
  uint32_t b[4];
  ldmatrix_x4(b, tile + (n0 + (lane >> 4) * 8 + (lane & 7)) * ld + k0 +
                     ((lane >> 3) & 1) * 4);
  tf32_split<4>(b, hi, lo);
}

// The B fragment of k rows [k0, k0 + 8) and columns [n0, n0 + 8) of an
// operand stored [k][columns] with row pitch ld floats, under the permuted
// k of an A operand taken from a C tile: rows k0 + 2t and k0 + 2t + 1.
// With ld = 4 (mod 16) the eight g of one t and the four t fall on
// distinct banks.
__device__ __forceinline__ void c_operand_b(const float* tile, int ld,
                                            int k0, int n0, uint32_t* hi,
                                            uint32_t* lo) {
  const int lane = threadIdx.x & 31;
  const float* p = tile + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
  tf32_split(p[0], hi[0], lo[0]);
  tf32_split(p[ld], hi[1], lo[1]);
}

// A C tile (c0..c3) as the A operand of the next product, split
__device__ __forceinline__ void c_as_a_split(const float* c, uint32_t* hi,
                                             uint32_t* lo) {
  tf32_split(c[0], hi[0], lo[0]);
  tf32_split(c[2], hi[1], lo[1]);
  tf32_split(c[1], hi[2], lo[2]);
  tf32_split(c[3], hi[3], lo[3]);
}

// cp.async of 16 bytes, zero-filled (nothing read) where !valid; src must
// be a mapped address either way
__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src,
                                                bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [r0, r0 + rows) of one head (base: row 0 of the head, rs the
// row stride in floats, 16-byte aligned) into shared memory with row pitch
// ld, by cp.async over nthreads threads; rows at or past S are zero.
template <int D>
__device__ __forceinline__ void stage_rows_async(const float* __restrict__ base,
                                                 long long rs, int r0,
                                                 int rows, int S, float* dst,
                                                 int ld, int nthreads) {
  constexpr int VPR = D / 4;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < rows * VPR; i += nthreads) {
    const int r = i / VPR, c = (i % VPR) * 4;
    const bool in = r0 + r < S;
    cp_async16_zfill(dst + r * ld + c,
                     base + (in ? (long long)(r0 + r) * rs + c : 0), in);
  }
}
