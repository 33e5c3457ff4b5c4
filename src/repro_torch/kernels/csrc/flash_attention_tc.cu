// flash_attention, bf16: causal / sliding-window GQA attention forward on
// Hopper's tensor cores.  q, k, v bf16 in [B, S, H, D] with any 16-byte
// strides, fp32 accumulators, out bf16.
//
// Replaces the bf16 path of repro/kernels/flash_attention.py::flash_attention
// (pallas_call at flash_attention.py:98, body _fa_kernel); the fp32 path stays
// the SIMT kernel of flash_attention.cu, since fp32 inputs would need TF32 on
// the tensor cores.  The TPU kernel carries m, l and the accumulator across a
// sequential kv grid axis in VMEM; here one CTA owns one (batch, q head,
// 128-row q tile) and loops over kv tiles of BK keys with m, l and the
// accumulator in registers.
//
// Bound on the H100: at the qwen3-8b prefill shape (B = 2, S = 4,096, 32 q
// heads, 8 kv heads, D = 128, causal) the work is ~2.75e11 FLOP, 0.28 ms at
// 989 TFLOP/s of bf16 tensor cores, against ~0.05 ms for q, k, v and out at
// 3.35 TB/s: bound by operations.  So both products run on the tensor cores
// as wgmma, fed by TMA:
//
// - Warp roles.  384 threads: warpgroups 0 and 1 are consumers, 64 q rows
//   each; warpgroup 2 is the producer, one thread of which issues every TMA
//   copy.  setmaxnreg hands registers from the producer (40) to the
//   consumers (232).
// - Shared memory.  Q (loaded once) and a ring of two K/V stages, all bf16
//   in 64-column slabs of 128-byte rows with TMA's
//   128-byte swizzle, which the wgmma descriptors name (layout type 1).
//   Each stage has a full barrier (TMA bytes) and an empty one (the 8
//   consumer warps).  D = 96 is held as 128 columns: the box past the
//   tensor's 96 columns is filled with zeros by TMA; q.k runs 6 k-steps and
//   p.v writes 128 columns, of which 96 are stored.  D = 16 (the reduced
//   configs' head dim) is held as one 64-column slab the same way: one
//   k-step, 64 columns written by p.v, 16 stored.
// - Overlap.  The producer's copies of the next tile overlap the consumers'
//   work on this one.  Inside a warpgroup each tile runs S = Q K^T, the
//   softmax and O += P V in turn; the two warpgroups overlap each other only
//   as far as they drift apart.  (Issuing the next tile's products before
//   this tile's softmax, or taking turns on the tensor cores through named
//   barriers, measured slower: ptxas serialized the wgmmas for want of
//   registers, PERF.md.)
// - S = Q K^T: wgmma m64nBKk16, Q and K K-major from shared memory.
// - O += P V: wgmma m64nNk16 with P in registers as the A operand (the
//   accumulator's layout is the A fragment's: no shuffle), V MN-major from
//   shared memory through the transpose bit.  P is rounded to bf16, as the
//   reference's p.astype(v.dtype), while l sums the unrounded P.
// - Softmax in base 2: scores are scaled by scale * log2(e) and exponentiated
//   with exp2f (tests/test_torch_flash_attention.py replays the formula).
// - Masks (keys past Sk, causal q_pos >= k_pos with q_pos = (Sk - Sq) + i,
//   window q_pos - k_pos < window; masked scores -1e30) are applied only on
//   tiles that straddle the diagonal, the window edge or Sk, decided per
//   consumer warpgroup.  Tiles wholly outside the band or the window are
//   skipped, as in flash_attention.cu (the argument there holds per tile of
//   any size).
// - Output acc / max(l, 1e-30) in bf16, stored row-masked from registers;
//   given a pointer, each row's log-sum-exp in natural log, (m + log2(max(l,
//   1e-30))) / log2(e) from the base-2 m and l, as float32 [B, Sq, H] for the
//   backward (flash_attention_bwd.cu).
#include "abi.cuh"
#include "mbarrier.cuh"

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <chrono>

#define TC_BQ RT_FA_TC_BQ  // q rows of one CTA (two consumer warpgroups)
#define TC_THREADS 384   // consumers 0-255, producer 256-383
#define TC_CONSUMERS 256
#define TC_NEG_INF (-1e30f)

// keys of one kv tile by head dim
static constexpr int tc_bk(int D) {
  return D > 128 ? RT_FA_TC_BK_WIDE : RT_FA_TC_BK;
}

template <int D>
struct TcTile {
  static constexpr int DP = (D + 63) / 64 * 64;  // columns held (D = 96: 128)
  static constexpr int BK = tc_bk(D);
  static constexpr int STAGES = 2;  // K/V stages (3 measured no faster)
  static constexpr int SLABS = DP / 64;          // 64-column slabs
  static constexpr int Q_SLAB = TC_BQ * 128;     // bytes of one Q slab
  static constexpr int KV_SLAB = BK * 128;       // bytes of one K or V slab
  static constexpr int KV_BYTES = SLABS * KV_SLAB;
  static constexpr int Q_BYTES = SLABS * Q_SLAB;
  static constexpr int SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 2 * STAGES);
};

// ---- PTX helpers ----------------------------------------------------------

// TMA: one box of a 4-d tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset (MN-major: the stride between 64-column slabs; unused K-major)
// and stride byte offset (between 8-row groups: 8 rows x 128 bytes)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep reads of accumulators after the wait, and register operands live
// until it
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64]; A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128]; A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64]; A in registers (bf16 pairs), B
// MN-major in shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128]; A in registers (bf16 pairs), B
// MN-major in shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int BK>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (BK == 128) wgmma_ss_n128(d, da, db, accumulate);
  else wgmma_ss_n64(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n64(d, a, db);
}

// ---- the kernel -----------------------------------------------------------

struct TcArgs {
  void* o;
  float* lse;  // [B, Sq, H] or null
  int H, G, Sq, Sk;
  long long osb, oss, osh;
  float scale_log2;  // softmax scale * log2(e)
  int causal, window;
};

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
    fa_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const TcArgs a) {
  using T = TcTile<D>;
  constexpr int BK = T::BK;
  constexpr int PV_N = T::DP > 128 ? 128 : T::DP;  // columns of one p.v wgmma
  constexpr int PV_PARTS = T::DP / PV_N;
  constexpr int NO = T::DP / 2;                     // accumulator floats
  extern __shared__ uint8_t tc_smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(tc_smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQ = base;
  uint8_t* sK = sQ + T::Q_BYTES;                 // [stage][slab][BK][64]
  uint8_t* sV = sK + T::STAGES * T::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + T::STAGES * T::KV_BYTES);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + T::STAGES;

  // the last q tiles see the most keys under the causal mask: launch them
  // first, for every head, so that the short tiles fill the tail
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H, kvh = h / a.G;
  const int q0 = qt * TC_BQ;
  const int q_offset = a.Sk - a.Sq;
  const int qp_lo = q_offset + q0;
  const int qp_hi = q_offset + min(q0 + TC_BQ, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, qp_hi + 1) : a.Sk;
  const int k_begin =
      a.window > 0 ? max(0, qp_lo - a.window + 1) / BK * BK : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], TC_CONSUMERS / 32);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= TC_CONSUMERS) {
    // ---- producer warpgroup: one thread issues every copy ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == TC_CONSUMERS) {
      mbar_expect_tx(q_full, T::Q_BYTES);
      for (int j = 0; j < T::SLABS; ++j)
        tma_load_4d(sQ + j * T::Q_SLAB, &qmap, q_full, 64 * j, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % T::STAGES;
        mbar_wait(&kv_empty[s], ((t / T::STAGES) & 1) ^ 1);
        mbar_expect_tx(&kv_full[s], 2 * T::KV_BYTES);
        const int k0 = k_begin + t * BK;
        for (int j = 0; j < T::SLABS; ++j) {
          tma_load_4d(sK + s * T::KV_BYTES + j * T::KV_SLAB, &kmap,
                      &kv_full[s], 64 * j, k0, kvh, b);
          tma_load_4d(sV + s * T::KV_BYTES + j * T::KV_SLAB, &vmap,
                      &kv_full[s], 64 * j, k0, kvh, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each ----
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    // accumulator element 4 j + e sits at row r + 8 (e / 2) of this
    // warpgroup's 64 and column 8 j + 2 t4 + (e % 2)
    const int r = 16 * warp + g;
    const int qpos0 = qp_lo + 64 * wg + r, qpos1 = qpos0 + 8;
    const int wg_lo = qp_lo + 64 * wg, wg_hi = wg_lo + 63;

    float o[NO], sacc[BK / 2];
    uint32_t p[BK / 4];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    float m0 = TC_NEG_INF, m1 = TC_NEG_INF, l0 = 0.f, l1 = 0.f;
    const uint32_t q_addr = smem_u32(sQ) + 64 * wg * 128;
    mbar_wait(q_full, 0);
    __syncwarp();

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % T::STAGES;
      const int k0 = k_begin + t * BK;
      const uint32_t k_addr = smem_u32(sK + s * T::KV_BYTES);
      const uint32_t v_addr = smem_u32(sV + s * T::KV_BYTES);
      mbar_wait(&kv_full[s], (t / T::STAGES) & 1);
      __syncwarp();

      // S = Q K^T over the D columns (16 a step; 32 bytes within a slab)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<BK>(sacc,
                     gmma_desc(q_addr + (kk / 4) * T::Q_SLAB + off, 16),
                     gmma_desc(k_addr + (kk / 4) * T::KV_SLAB + off, 16),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<BK / 2>(sacc);

      // scale into base 2, mask the tiles that straddle an edge
      const bool edge = k0 + BK > a.Sk || (a.causal && k0 + BK - 1 > wg_lo) ||
                        (a.window > 0 && wg_hi - k0 >= a.window);
      float mx0 = TC_NEG_INF, mx1 = TC_NEG_INF;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float v = sacc[i] * a.scale_log2;
        if (edge) {
          const int kpos = k0 + 8 * (i / 4) + 2 * t4 + (i % 2);
          const int qpos = (i % 4) < 2 ? qpos0 : qpos1;
          bool ok = kpos < a.Sk;
          if (a.causal) ok = ok && qpos >= kpos;
          if (a.window > 0) ok = ok && (qpos - kpos) < a.window;
          v = ok ? v : TC_NEG_INF;
        }
        sacc[i] = v;
        if ((i % 4) < 2) mx0 = fmaxf(mx0, v);
        else mx1 = fmaxf(mx1, v);
      }
      // the four lanes of a quad hold one row's columns
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;

      // P = exp2(S - m), rounded to bf16 in the A fragment's pairs; l sums
      // this lane's share of the unrounded P (the quad is summed at the end)
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float p00 = exp2f(sacc[4 * j] - mn0);
        const float p01 = exp2f(sacc[4 * j + 1] - mn0);
        const float p10 = exp2f(sacc[4 * j + 2] - mn1);
        const float p11 = exp2f(sacc[4 * j + 3] - mn1);
        s0 += p00 + p01;
        s1 += p10 + p11;
        p[2 * j] = pack_bf16(p00, p01);
        p[2 * j + 1] = pack_bf16(p10, p11);
      }
      l0 = l0 * c0 + s0;
      l1 = l1 * c1 + s1;
      // rescale O unless no row max of this warp moved (a multiply by 1)
      if (!__all_sync(0xffffffffu, c0 == 1.f && c1 == 1.f)) {
#pragma unroll
        for (int i = 0; i < NO; ++i) o[i] *= (i % 4) < 2 ? c0 : c1;
      }

      // O += P V: 16 keys a step, V's rows 16 kk.. (2,048 bytes a step)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int part = 0; part < PV_PARTS; ++part)
          wgmma_rs<PV_N>(o + part * (PV_N / 2), p + 4 * kk,
                         gmma_desc(v_addr + kk * 16 * 128 +
                                       part * (PV_N / 64) * T::KV_SLAB,
                                   T::KV_SLAB));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<NO>(o);
      fence_regs<BK / 4>(p);
      __syncwarp();
      if (lane == 0) mbar_arrive(&kv_empty[s]);
    }

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
    const int row0 = q0 + 64 * wg + r, row1 = row0 + 8;
    if (a.lse && t4 == 0) {
      constexpr float LN2 = 0.69314718055994531f;
      if (row0 < a.Sq)
        a.lse[((long long)b * a.Sq + row0) * a.H + h] =
            (m0 + log2f(den0)) * LN2;
      if (row1 < a.Sq)
        a.lse[((long long)b * a.Sq + row1) * a.H + h] =
            (m1 + log2f(den1)) * LN2;
    }
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.o) + b * a.osb +
                        h * a.osh;
#pragma unroll
    for (int i = 0; i < NO; i += 2) {
      const int col = 8 * (i / 4) + 2 * t4;
      if (col >= D) continue;
      const bool lower = (i % 4) >= 2;
      const int row = lower ? row1 : row0;
      if (row >= a.Sq) continue;
      const float den = lower ? den1 : den0;
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row * a.oss + col) =
          __floats2bfloat162_rn(o[i] / den, o[i + 1] / den);
    }
  }
}

// ---- host side ------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call: take its entry point from the
// runtime, so that the library needs no -lcuda
static EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a 4-d map (D, S, H, B) of a bf16 [B, S, H, D] tensor with element strides
// (sb, ss, sh) and a contiguous head dim; boxes of 64 columns x rows.  A dim
// of extent 1 takes a placeholder stride (its stride is never used).
static int encode_map(CUtensorMap* map, const void* ptr, int D, int S, int H,
                      int B, long long sb, long long ss, long long sh,
                      int rows) {
  EncodeTiledFn fn = encode_fn();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t pad = 2ull * D;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {S > 1 ? 2ull * ss : pad, H > 1 ? 2ull * sh : pad,
                           B > 1 ? 2ull * sb : pad};
  cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(ptr), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

struct TcMaps {
  CUtensorMap q, k, v;
};

static int encode_maps(TcMaps* m, const void* q, const void* k, const void* v,
                       int B, int Sq, int Sk, int H, int KH, int D, int bk,
                       const long long* st) {
  int rc = encode_map(&m->q, q, D, Sq, H, B, st[0], st[1], st[2], TC_BQ);
  if (!rc) rc = encode_map(&m->k, k, D, Sk, KH, B, st[3], st[4], st[5], bk);
  if (!rc) rc = encode_map(&m->v, v, D, Sk, KH, B, st[6], st[7], st[8], bk);
  return rc;
}

template <int D>
static int tc_launch(const void* q, const void* k, const void* v,
                     const TcArgs& a, int B, int KH, const long long* st,
                     cudaStream_t stream) {
  using T = TcTile<D>;
  static_assert(T::SMEM <= RT_SMEM_BYTES, "flash_attention_tc tile too large");
  TcMaps m;
  int rc = encode_maps(&m, q, k, v, B, a.Sq, a.Sk, a.H, KH, D, T::BK, st);
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      fa_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * a.H, (a.Sq + TC_BQ - 1) / TC_BQ);
  fa_tc_kernel<D><<<grid, TC_THREADS, T::SMEM, stream>>>(m.q, m.k, m.v, a);
  return (int)cudaGetLastError();
}

// bf16 q, k, v, out.  strides[12] = q, k, v, out strides of (batch, seq,
// head) in elements; the head dim is contiguous.  scale_log2 = scale *
// log2(e).  lse: contiguous float32 [B, Sq, H], or null.
extern "C" int rt_flash_attention_tc(const void* q, const void* k,
                                     const void* v, void* o, float* lse,
                                     int B, int Sq, int Sk, int H, int KH,
                                     int D,
                                     const long long* strides,
                                     float scale_log2, int causal, int window,
                                     void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KH < 1 || H % KH != 0 ||
      (Sq + TC_BQ - 1) / TC_BQ > 65535)
    return (int)cudaErrorInvalidValue;
  TcArgs a{o, lse, H, H / KH, Sq, Sk, strides[9], strides[10], strides[11],
           scale_log2, causal, window};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return tc_launch<16>(q, k, v, a, B, KH, strides, s);
    case 64: return tc_launch<64>(q, k, v, a, B, KH, strides, s);
    case 96: return tc_launch<96>(q, k, v, a, B, KH, strides, s);
    case 128: return tc_launch<128>(q, k, v, a, B, KH, strides, s);
    case 256: return tc_launch<256>(q, k, v, a, B, KH, strides, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dynamic shared memory of one CTA at head dim D (0 if D is not built)
extern "C" int rt_flash_attention_tc_smem(int D) {
  switch (D) {
    case 16: return TcTile<16>::SMEM;
    case 64: return TcTile<64>::SMEM;
    case 96: return TcTile<96>::SMEM;
    case 128: return TcTile<128>::SMEM;
    case 256: return TcTile<256>::SMEM;
    default: return 0;
  }
}

// Host cost of the three tensor maps one launch encodes: mean ns per
// launch's worth over `iters` encodings (no launch).
extern "C" long long rt_flash_attention_tc_encode_ns(
    const void* q, const void* k, const void* v, int B, int Sq, int Sk, int H,
    int KH, int D, const long long* strides, int iters) {
  TcMaps m;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    if (encode_maps(&m, q, k, v, B, Sq, Sk, H, KH, D, tc_bk(D), strides))
      return -1;
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0)
             .count() / (iters > 0 ? iters : 1);
}
