// flash_attention_bwd: the backward of causal / sliding-window GQA attention,
// fp32 in and out, fp32 accumulators.  q, dq, out, dout [B, Sq, H, D],
// k, v, dk, dv [B, Sk, KH, D], all contiguous; lse [B, Sq, H] fp32, the
// forward's log-sum-exp (flash_attention.cu / flash_attention_tc.cu write it).
//
// Replaces no Pallas kernel: the reference's gradient is XLA code, the
// streaming custom VJP repro/models/flash_cvjp.py::_bwd_impl, and this kernel
// computes what it computes, in its two passes:
//
//   D_i  = rowsum(dO_i * O_i)
//   p_ij = exp(q_i k_j^T * scale - lse_i)          (recomputed, masked to 0)
//   ds   = p_ij * (dO_i v_j^T - D_i) * scale
//   dq_i = sum_j ds k_j;   dv_j = sum_i p^T dO_i;   dk_j = sum_i ds^T q_i
//
// Pass 1 (fa_bwd_dq_kernel): one CTA per (batch, q head, 64-row q tile), four
// warps of 16 rows.  It stages q and dO, computes D for its rows (written to
// a [B, H, Sq] fp32 scratch for pass 2), then streams the 16-key tiles its
// rows can see, with dq in registers.  Pass 2 (fa_bwd_dkv_kernel): one CTA
// per (batch, q head, 64-key tile), four warps of 16 keys, and per column
// block of 128 at D = 256; it walks the 16-row q tiles of its q head that
// see its keys, with dk and dv in registers.  Where G > 1 q heads share a kv
// head, pass 2 writes each q head's share to an fp32 scratch and
// fa_bwd_sum_kernel adds the G shares in head order.  Every element of dq,
// dk, dv and the scratch has one writer and a fixed summation order: no
// atomics, and the result does not depend on the launch.  Masks follow
// flash_cvjp._mask: keys past Sk, causal q_pos >= k_pos with
// q_pos = (Sk - Sq) + i, window q_pos - k_pos < window; a masked p is
// exactly 0, so tiles wholly outside the band are skipped with no change to
// any sum.  bf16 runs on the tensor cores with wgmma instead
// (flash_attention_bwd_tc.cu).
//
// Bound on the H100: operations.  At the qwen3-8b training shape (q [1, 4096,
// 32, 128], k/v [1, 4096, 8, 128], causal) the backward needs ~344 GFLOP (2.5
// times the forward's 137).  Every product runs on the tensor cores in split
// TF32 (split_tf32.cuh: three TF32 mma.sync products per fp32 product, an
// fp32 FMA loop's accuracy): 3 x 344 GFLOP at the 495 TFLOP/s of dense
// TF32.  Pass 1 recomputes the scores and dO v^T that pass 2 computes
// again, 14 D FLOPs per visible (q, k) pair against the 10 D of the bound.
// Operands stored [rows][d] load by ldmatrix; P and dS go from the
// registers of the product that made them into the next one's A operand
// (their key or row index permuted), the other side by scalar loads of
// rows 2t, 2t + 1.  Each k-step of a score product folds into fp32
// registers; a gradient product chains its big and small products apart
// over the tile and folds both into dq, dk or dv, so no tensor-core sum
// runs past one tile.  Only tiles that straddle the band compute the mask.
// The streamed tiles come through a two-stage cp.async ring.
#include "abi.cuh"
#include "split_tf32.cuh"

#include <stdint.h>

#define FB_THREADS 128   // four warps
#define FB_BQ 64         // pass 1: q rows of one CTA, 16 a warp
#define FB_BK 16         // pass 1: keys of one kv tile
#define FB_BKV 64        // pass 2: keys of one CTA, 16 a warp
#define FB_BQ2 16        // pass 2: q rows of one q tile
#define FB_NEG_INF (-1e30f)

struct FbArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;  // [B, Sq, H]
  float* dq;
  float* dk;
  float* dv;
  float* dl;         // [B, H, Sq] scratch: rowsum(dO * O)
  float* part;       // G > 1: [2, B, Sk, H, D] scratch, each q head's dk, dv
  int H, KH, G, Sq, Sk;
  float scale;
  int causal, window;
};

// row pitch of every tile, in floats (see c_operand_b)
template <int D>
__host__ __device__ constexpr int fb_ld() {
  return D + 4;
}

template <int D>
constexpr int fb_dq_smem() {
  return 4 * (2 * FB_BQ + 4 * FB_BK) * fb_ld<D>();
}

template <int D>
constexpr int fb_dkv_smem() {
  return 4 * (2 * FB_BKV + 4 * FB_BQ2) * fb_ld<D>();
}

__device__ __forceinline__ bool fb_visible(const FbArgs& a, int qpos,
                                           int kpos) {
  bool ok = kpos < a.Sk;
  if (a.causal) ok = ok && qpos >= kpos;
  if (a.window > 0) ok = ok && (qpos - kpos) < a.window;
  return ok;
}

// ---- pass 1: D and dq ------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(FB_THREADS, 2)
    fa_bwd_dq_kernel(const FbArgs a) {
  constexpr int LD = fb_ld<D>();
  constexpr int NS = FB_BK / 8;  // 8-key column tiles of S
  constexpr int NO = D / 8;      // 8-column tiles of dq
  static_assert(NS == 2, "one ldmatrix.x4 of K or V per k-step");
  extern __shared__ float4 fb_smem[];
  float* Qs = reinterpret_cast<float*>(fb_smem);  // [FB_BQ][LD]
  float* dOs = Qs + FB_BQ * LD;                   // [FB_BQ][LD]
  float* Ks = dOs + FB_BQ * LD;                   // [2][FB_BK][LD]
  float* Vs = Ks + 2 * FB_BK * LD;                // [2][FB_BK][LD]
  __shared__ float lse_s[FB_BQ], dl_s[FB_BQ];

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's first row
  // the last q tiles see the most keys under the causal mask: first, every
  // head's
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H, kvh = h / a.G;
  const int q0 = qt * FB_BQ;
  const long long qrs = (long long)a.H * D, krs = (long long)a.KH * D;
  const long long qhead = ((long long)b * a.Sq * a.H + h) * D;
  const long long khead = ((long long)b * a.Sk * a.KH + kvh) * D;
  const float* kb = a.k + khead;
  const float* vb = a.v + khead;

  const int q_offset = a.Sk - a.Sq;
  const int qp_lo = q_offset + q0;
  const int qp_hi = q_offset + min(q0 + FB_BQ, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, qp_hi + 1) : a.Sk;
  const int k_begin =
      a.window > 0 ? max(0, qp_lo - a.window + 1) / FB_BK * FB_BK : 0;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + FB_BK - 1) / FB_BK
                                     : 0;

  stage_rows_async<D>(a.q + qhead, qrs, q0, FB_BQ, a.Sq, Qs, LD, FB_THREADS);
  stage_rows_async<D>(a.dout + qhead, qrs, q0, FB_BQ, a.Sq, dOs, LD,
                      FB_THREADS);
  if (ntiles > 0) {
    stage_rows_async<D>(kb, krs, k_begin, FB_BK, a.Sk, Ks, LD, FB_THREADS);
    stage_rows_async<D>(vb, krs, k_begin, FB_BK, a.Sk, Vs, LD, FB_THREADS);
  }
  cp_async_commit();

  // D_i = rowsum(dO_i * O_i), a warp per row, while the copies fly
#pragma unroll 4
  for (int r = wr; r < wr + 16; ++r) {
    const int row = q0 + r;
    float sdl = 0.f;
    if (row < a.Sq) {
      const float* gr = a.dout + qhead + row * qrs;
      const float* orow = a.o + qhead + row * qrs;
      for (int c = lane * 4; c < D; c += 128) {
        const float4 x = *reinterpret_cast<const float4*>(gr + c);
        const float4 y = *reinterpret_cast<const float4*>(orow + c);
        sdl = fmaf(x.x, y.x, sdl);
        sdl = fmaf(x.y, y.y, sdl);
        sdl = fmaf(x.z, y.z, sdl);
        sdl = fmaf(x.w, y.w, sdl);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sdl += __shfl_xor_sync(0xffffffffu, sdl, off);
    if (lane == 0) {
      dl_s[r] = sdl;
      lse_s[r] = row < a.Sq ? a.lse[((long long)b * a.Sq + row) * a.H + h]
                            : 0.f;
      if (row < a.Sq) a.dl[((long long)b * a.H + h) * a.Sq + row] = sdl;
    }
  }
  __syncwarp();
  const float lse[2] = {lse_s[wr + g], lse_s[wr + g + 8]};
  const float dl[2] = {dl_s[wr + g], dl_s[wr + g + 8]};

  float dq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = k_begin + it * FB_BK;
    const float* Kt = Ks + (it & 1) * FB_BK * LD;
    const float* Vt = Vs + (it & 1) * FB_BK * LD;
    __syncthreads();  // the other stage's last reads are done
    if (it + 1 < ntiles) {
      stage_rows_async<D>(kb, krs, k0 + FB_BK, FB_BK, a.Sk,
                          Ks + ((it + 1) & 1) * FB_BK * LD, LD, FB_THREADS);
      stage_rows_async<D>(vb, krs, k0 + FB_BK, FB_BK, a.Sk,
                          Vs + ((it + 1) & 1) * FB_BK * LD, LD, FB_THREADS);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // s = q k^T and dp = dO v^T for the warp's 16 rows and the tile's keys
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D; kk += 8) {
      uint32_t qhi[4], qlo[4], ghi[4], glo[4], khi[4], klo[4], vhi[4],
          vlo[4];
      load_a_split(Qs, LD, wr, kk, qhi, qlo);
      load_a_split(dOs, LD, wr, kk, ghi, glo);
      load_b2_split(Kt, LD, 0, kk, khi, klo);
      load_b2_split(Vt, LD, 0, kk, vhi, vlo);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float c[4] = {0.f, 0.f, 0.f, 0.f}, d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_split(c, c, qhi, qlo, khi + 2 * j, klo + 2 * j);
        mma_split(d, d, ghi, glo, vhi + 2 * j, vlo + 2 * j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] += c[e];
          dp[j][e] += d[e];
        }
      }
    }

    // ds = p (dp - D) scale (the mask only where the tile straddles the
    // band), then dq += ds k
    const bool whole = k0 + FB_BK <= a.Sk &&
                       (!a.causal || k0 + FB_BK - 1 <= qp_lo + wr) &&
                       (a.window <= 0 || qp_lo + wr + 15 - k0 < a.window);
    uint32_t dhi[NS][4], dlo[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p =
            whole || fb_visible(a, qp_lo + wr + g + 8 * r,
                                k0 + j * 8 + 2 * t + (e & 1))
                ? expf(s[j][e] * a.scale - lse[r])
                : 0.f;
        s[j][e] = p * (dp[j][e] - dl[r]) * a.scale;
      }
      c_as_a_split(s[j], dhi[j], dlo[j]);
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      float c[4] = {0.f, 0.f, 0.f, 0.f}, cl[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t bhi[2], blo[2];
        c_operand_b(Kt, LD, j * 8, n * 8, bhi, blo);
        mma_split(c, cl, dhi[j], dlo[j], bhi, blo);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[n][e] += c[e] + cl[e];
    }
  }
  cp_async_wait<0>();

  float* dqb = a.dq + qhead;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    if (row >= a.Sq) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(dqb + row * qrs + n * 8 + 2 * t) =
          make_float2(dq[n][2 * r], dq[n][2 * r + 1]);
  }
}

// ---- pass 2: dk and dv -----------------------------------------------------

// Stage one q tile of pass 2: q and dO rows [q0, q0 + FB_BQ2) and their lse
// and D.
template <int D>
__device__ __forceinline__ void fb_stage_q(const FbArgs& a, int b, int h,
                                           int q0, float* Qt, float* dOt,
                                           float* rows) {
  constexpr int LD = fb_ld<D>();
  const long long qrs = (long long)a.H * D;
  const long long qhead = ((long long)b * a.Sq * a.H + h) * D;
  stage_rows_async<D>(a.q + qhead, qrs, q0, FB_BQ2, a.Sq, Qt, LD,
                      FB_THREADS);
  stage_rows_async<D>(a.dout + qhead, qrs, q0, FB_BQ2, a.Sq, dOt, LD,
                      FB_THREADS);
  if (threadIdx.x < 2 * FB_BQ2) {
    const int i = threadIdx.x % FB_BQ2, row = q0 + i;
    const bool in = row < a.Sq;
    const float* src =
        threadIdx.x < FB_BQ2
            ? a.lse + (in ? ((long long)b * a.Sq + row) * a.H + h : 0)
            : a.dl + (in ? ((long long)b * a.H + h) * a.Sq + row : 0);
    cp_async4_zfill(rows + threadIdx.x, src, in);
  }
}

template <int D, int NDC>
__global__ void __launch_bounds__(FB_THREADS, 2)
    fa_bwd_dkv_kernel(const FbArgs a) {
  constexpr int LD = fb_ld<D>();
  constexpr int NS = FB_BQ2 / 8;  // 8-row column tiles of S^T
  constexpr int NO = NDC / 8;     // 8-column tiles of dk / dv
  static_assert(NS == 2, "one ldmatrix.x4 of Q or dO per k-step");
  extern __shared__ float4 fb_smem[];
  float* Ks = reinterpret_cast<float*>(fb_smem);  // [FB_BKV][LD]
  float* Vs = Ks + FB_BKV * LD;                   // [FB_BKV][LD]
  float* Qs = Vs + FB_BKV * LD;                   // [2][FB_BQ2][LD]
  float* dOs = Qs + 2 * FB_BQ2 * LD;              // [2][FB_BQ2][LD]
  __shared__ __align__(16) float rows_s[2][2 * FB_BQ2];  // lse, then D

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wk = (threadIdx.x >> 5) * 16;  // the warp's first key
  // the first key tiles are seen by the most q rows under the causal mask:
  // first, every head's
  const int k0 = blockIdx.y * FB_BKV;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H, kvh = h / a.G;
  const int c0 = blockIdx.z * NDC;  // the CTA's dk / dv columns
  const long long krs = (long long)a.KH * D;
  const long long khead = ((long long)b * a.Sk * a.KH + kvh) * D;
  stage_rows_async<D>(a.k + khead, krs, k0, FB_BKV, a.Sk, Ks, LD,
                      FB_THREADS);
  stage_rows_async<D>(a.v + khead, krs, k0, FB_BKV, a.Sk, Vs, LD,
                      FB_THREADS);

  // the q rows that can see a key of this tile
  const int q_offset = a.Sk - a.Sq;
  const int q_lo = a.causal ? max(0, k0 - q_offset) / FB_BQ2 * FB_BQ2 : 0;
  const int q_hi =
      a.window > 0 ? min(a.Sq, k0 + FB_BKV - 1 + a.window - q_offset) : a.Sq;
  const int ntiles =
      q_hi > q_lo ? (q_hi - q_lo + FB_BQ2 - 1) / FB_BQ2 : 0;
  if (ntiles > 0)
    fb_stage_q<D>(a, b, h, q_lo, Qs, dOs, rows_s[0]);
  cp_async_commit();

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int q0 = q_lo + it * FB_BQ2;
    const float* Qt = Qs + (it & 1) * FB_BQ2 * LD;
    const float* dOt = dOs + (it & 1) * FB_BQ2 * LD;
    const float* lse_t = rows_s[it & 1];
    const float* dl_t = lse_t + FB_BQ2;
    __syncthreads();  // the other stage's last reads are done
    if (it + 1 < ntiles)
      fb_stage_q<D>(a, b, h, q0 + FB_BQ2, Qs + ((it + 1) & 1) * FB_BQ2 * LD,
                    dOs + ((it + 1) & 1) * FB_BQ2 * LD, rows_s[(it + 1) & 1]);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // s^T = k q^T and dp^T = v dO^T for the warp's 16 keys and the tile's
    // 16 q rows
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D; kk += 8) {
      uint32_t khi[4], klo[4], vhi[4], vlo[4], qhi[4], qlo[4], ghi[4],
          glo[4];
      load_a_split(Ks, LD, wk, kk, khi, klo);
      load_a_split(Vs, LD, wk, kk, vhi, vlo);
      load_b2_split(Qt, LD, 0, kk, qhi, qlo);
      load_b2_split(dOt, LD, 0, kk, ghi, glo);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float c[4] = {0.f, 0.f, 0.f, 0.f}, d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_split(c, c, khi, klo, qhi + 2 * j, qlo + 2 * j);
        mma_split(d, d, vhi, vlo, ghi + 2 * j, glo + 2 * j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] += c[e];
          dp[j][e] += d[e];
        }
      }
    }

    // p^T and ds^T (the mask only where the tile straddles the band or Sq),
    // then dv += p^T dO and dk += ds^T q
    const bool whole =
        q0 + FB_BQ2 <= a.Sq && k0 + wk + 16 <= a.Sk &&
        (!a.causal || q_offset + q0 >= k0 + wk + 15) &&
        (a.window <= 0 || q_offset + q0 + FB_BQ2 - 1 - (k0 + wk) < a.window);
    uint32_t phi[NS][4], plo[NS][4], dhi[NS][4], dlo[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + wk + g + 8 * (e >> 1);
        const int qi = j * 8 + 2 * t + (e & 1), qrow = q0 + qi;
        const float p =
            whole || (qrow < a.Sq && fb_visible(a, q_offset + qrow, kpos))
                ? expf(s[j][e] * a.scale - lse_t[qi])
                : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dl_t[qi]) * a.scale;
      }
      c_as_a_split(s[j], phi[j], plo[j]);
      c_as_a_split(dp[j], dhi[j], dlo[j]);
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      float c[4] = {0.f, 0.f, 0.f, 0.f}, cl[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t bhi[2], blo[2];
        c_operand_b(dOt, LD, j * 8, c0 + n * 8, bhi, blo);
        mma_split(c, cl, phi[j], plo[j], bhi, blo);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[n][e] += c[e] + cl[e];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      float c[4] = {0.f, 0.f, 0.f, 0.f}, cl[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t bhi[2], blo[2];
        c_operand_b(Qt, LD, j * 8, c0 + n * 8, bhi, blo);
        mma_split(c, cl, dhi[j], dlo[j], bhi, blo);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] += c[e] + cl[e];
    }
  }
  cp_async_wait<0>();

  // G == 1: dk and dv themselves; else this q head's share, [2, B, Sk, H, D]
  const bool whole = a.G == 1;
  const long long rs = whole ? krs : (long long)a.H * D;
  const long long base =
      whole ? khead : ((long long)b * a.Sk * a.H + h) * D;
  float* dkb = (whole ? a.dk : a.part) + base;
  float* dvb = (whole ? a.dv : a.part + (long long)gridDim.x * a.Sk * D) +
               base;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + wk + g + 8 * r;
    if (key >= a.Sk) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const long long off = key * rs + c0 + n * 8 + 2 * t;
      *reinterpret_cast<float2*>(dkb + off) =
          make_float2(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<float2*>(dvb + off) =
          make_float2(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// dk, dv [B, Sk, KH, D] = the sum over g = 0 .. G - 1, in order, of the
// shares of q heads kvh * G + g in part [2, B, Sk, H, D]; four floats a
// thread, dk's then dv's
__global__ void __launch_bounds__(256)
    fa_bwd_sum_kernel(const float* __restrict__ part, float* dk, float* dv,
                      long long n4, long long half, int KH, int G, int D) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * n4) return;
  const bool second = i >= n4;
  const long long e = (second ? i - n4 : i) * 4;  // element of dk / dv
  const long long bs = e / ((long long)KH * D);   // b * Sk + key
  const int kvh = (int)(e / D % KH), d = (int)(e % D);
  const float* src =
      part + (second ? half : 0) + (bs * KH * G + (long long)kvh * G) * D + d;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int g = 1; g < G; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(src + (long long)g * D);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  *reinterpret_cast<float4*>((second ? dv : dk) + e) = acc;
}

// ---- host side ---------------------------------------------------------------

template <int D>
static int fb_launch(const FbArgs& a, int B, cudaStream_t stream) {
  constexpr int NDC = D > 128 ? 128 : D;  // dk / dv columns of one CTA
  constexpr int smem1 = fb_dq_smem<D>();
  constexpr int smem2 = fb_dkv_smem<D>();
  static_assert(smem1 + 4 * 2 * FB_BQ <= RT_SMEM_BYTES &&
                    smem2 + 4 * 4 * FB_BQ2 <= RT_SMEM_BYTES,
                "flash_attention_bwd tile too large");
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fa_bwd_dkv_kernel<D, NDC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem2);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid1(B * a.H, (a.Sq + FB_BQ - 1) / FB_BQ);
  fa_bwd_dq_kernel<D><<<grid1, FB_THREADS, smem1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2(B * a.H, (a.Sk + FB_BKV - 1) / FB_BKV, D / NDC);
  fa_bwd_dkv_kernel<D, NDC><<<grid2, FB_THREADS, smem2, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.G == 1) return (int)err;
  const long long n4 = (long long)B * a.Sk * a.KH * D / 4;
  const long long half = (long long)B * a.Sk * a.H * D;
  fa_bwd_sum_kernel<<<(unsigned)((2 * n4 + 255) / 256), 256, 0, stream>>>(
      a.part, a.dk, a.dv, n4, half, a.KH, a.G, D);
  return (int)cudaGetLastError();
}

// Both passes, in order on `stream`.  q, k, v, out, dout, dq, dk, dv, lse
// float32, every tensor contiguous.  scratch: float32, B * H * Sq rounded up
// to a multiple of 4 (D), then where H > KH 2 * B * Sk * H * D (each q
// head's dk and dv), 16-byte aligned.
extern "C" int rt_flash_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const float* lse,
                                      void* dq, void* dk, void* dv,
                                      float* scratch, int B, int Sq, int Sk,
                                      int H, int KH, int D, float scale,
                                      int causal, int window, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KH < 1 || H % KH != 0 ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  float* part = scratch + ((long long)B * H * Sq + 3) / 4 * 4;
  FbArgs a{static_cast<const float*>(q),    static_cast<const float*>(k),
           static_cast<const float*>(v),    static_cast<const float*>(o),
           static_cast<const float*>(dout), lse,
           static_cast<float*>(dq),         static_cast<float*>(dk),
           static_cast<float*>(dv),         scratch,
           part,                            H,
           KH,                              H / KH,
           Sq,                              Sk,
           scale,                           causal,
           window};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return fb_launch<16>(a, B, s);
    case 64: return fb_launch<64>(a, B, s);
    case 96: return fb_launch<96>(a, B, s);
    case 128: return fb_launch<128>(a, B, s);
    case 256: return fb_launch<256>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
