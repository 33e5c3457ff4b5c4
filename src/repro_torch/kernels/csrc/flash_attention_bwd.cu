// flash_attention_bwd: the backward of causal / sliding-window GQA attention,
// fp32 or bf16 in and out, fp32 accumulators.  q, dq, out, dout [B, Sq, H, D],
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
// Pass 1 (fa_bwd_dq_kernel): one CTA per (batch, q head, 64-row q tile).  It
// stages q, dO and O, computes D for its rows (written to a [B, H, Sq] fp32
// scratch for pass 2), then streams the key tiles its rows can see, with dq in
// registers.  Pass 2 (fa_bwd_dkv_kernel): one CTA per (batch, kv head, tile
// of 16 R keys); it walks the G q heads of its kv head and the q tiles that
// see its keys, with dk and dv in registers.  Every element of dq, dk and dv
// has one writer and a fixed summation order: no atomics, and the result does
// not depend on the launch.  Masks follow flash_cvjp._mask: keys past Sk,
// causal q_pos >= k_pos with q_pos = (Sk - Sq) + i, window q_pos - k_pos <
// window; a masked p is exactly 0, so tiles wholly outside the band are
// skipped with no change to any sum.  Roundings follow _bwd_impl: p is
// rounded to dO's type before dv, ds to k's type before dq and to q's type
// before dk (bf16 here: both are the input type); every product accumulates
// in fp32.
//
// Bound on the H100: operations.  At the qwen3-8b training shape (q [1, 4096,
// 32, 128], k/v [1, 4096, 8, 128], causal) the backward needs ~344 GFLOP (2.5
// times the forward's 137): 0.35 ms at 989 TFLOP/s of bf16 tensor cores, 5.1
// ms at 67 TFLOP/s of fp32 FMAs.  This first kernel is SIMT fp32 for both
// types (bf16 is widened as it is staged): pass 1 recomputes the scores and
// dO v^T that pass 2 computes again, 14 D FLOPs per visible (q, k) pair
// against the 10 D of the bound.  Tiles live in fp32 shared memory with rows
// padded by four floats so that eight rows of a quarter-warp fall on distinct
// banks, as in flash_attention.cu.  wgmma and TMA are later work.
#include "abi.cuh"

#include <cuda_bf16.h>
#include <stdint.h>

#define FB_THREADS 256   // 16 x 16 threads
#define FB_BQ 64         // pass 1: q rows of one CTA
#define FB_BK 32         // pass 1: keys of one kv tile
#define FB_BQ2 32        // pass 2: q rows of one q tile
#define FB_NEG_INF (-1e30f)

struct FbArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // [B, Sq, H]
  void* dq;
  void* dk;
  void* dv;
  float* dl;         // [B, H, Sq] scratch: rowsum(dO * O)
  int H, KH, G, Sq, Sk;
  float scale;
  int causal, window;
};

__device__ __forceinline__ float fb_round(float x, float) { return x; }
__device__ __forceinline__ float fb_round(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void fb_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void fb_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of T -> floats at d (d 16-byte aligned)
__device__ __forceinline__ void fb_unpack(const uint4 raw, float* d, float) {
  *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(&raw);
}
__device__ __forceinline__ void fb_unpack(const uint4 raw, float* d,
                                          __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), e = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(d)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(d)[1] = make_float4(c.x, c.y, e.x, e.y);
}

// Stage rows [r0, r0 + rows) of one head (base: row 0 of the head, rs the row
// stride in elements) as fp32 with row pitch ld; rows at or past S are zero.
// 16-byte global loads.
template <class T, int D>
__device__ __forceinline__ void fb_stage(const T* __restrict__ base,
                                         long long rs, int r0, int rows,
                                         int S, float* __restrict__ dst,
                                         int ld) {
  constexpr int EPV = 16 / sizeof(T);  // elements of one 16-byte vector
  constexpr int VPR = D / EPV;
  for (int i = threadIdx.x; i < rows * VPR; i += FB_THREADS) {
    const int r = i / VPR, c = (i % VPR) * EPV;
    float* d = dst + r * ld + c;
    if (r0 + r < S) {
      fb_unpack(*reinterpret_cast<const uint4*>(base + (long long)(r0 + r) *
                                                           rs + c),
                d, T());
    } else {
#pragma unroll
      for (int e = 0; e < EPV; e += 4)
        *reinterpret_cast<float4*>(d + e) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float t) {
  t = fmaf(a.x, b.x, t);
  t = fmaf(a.y, b.y, t);
  t = fmaf(a.z, b.z, t);
  return fmaf(a.w, b.w, t);
}

__device__ __forceinline__ bool fb_visible(const FbArgs& a, int qpos,
                                           int kpos) {
  bool ok = kpos < a.Sk;
  if (a.causal) ok = ok && qpos >= kpos;
  if (a.window > 0) ok = ok && (qpos - kpos) < a.window;
  return ok;
}

template <int D>
constexpr int fb_dq_smem() {
  return 4 * ((2 * FB_BQ + 2 * FB_BK) * (D + 4) + FB_BQ * (FB_BK + 4));
}

template <int D, int R>
constexpr int fb_dkv_smem() {
  return 4 * ((2 * 16 * R + 2 * FB_BQ2) * (D + 4) +
              2 * 16 * R * (FB_BQ2 + 4) + 2 * FB_BQ2);
}

// ---- pass 1: D and dq ------------------------------------------------------

template <class T, int D>
__global__ void __launch_bounds__(FB_THREADS) fa_bwd_dq_kernel(const FbArgs a) {
  constexpr int LD = D + 4;       // q, dO, k, v tile row pitch (floats)
  constexpr int LDP = FB_BK + 4;  // ds tile row pitch
  constexpr int NC = D / 16;      // dq columns per thread
  extern __shared__ float4 fb_smem[];
  float* Qs = reinterpret_cast<float*>(fb_smem);  // [FB_BQ][LD]
  float* dOs = Qs + FB_BQ * LD;                   // [FB_BQ][LD]
  float* Ks = dOs + FB_BQ * LD;                   // [FB_BK][LD]
  float* Vs = Ks + FB_BK * LD;                    // [FB_BK][LD]
  float* dSs = Vs + FB_BK * LD;                   // [FB_BQ][LDP]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // the last q tiles see the most keys under the causal mask: first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H, kvh = h / a.G;
  const int q0 = qt * FB_BQ;
  const long long qrs = (long long)a.H * D, krs = (long long)a.KH * D;
  const long long qhead = ((long long)b * a.Sq * a.H + h) * D;
  const long long khead = ((long long)b * a.Sk * a.KH + kvh) * D;
  const T* qb = static_cast<const T*>(a.q) + qhead;
  const T* ob = static_cast<const T*>(a.o) + qhead;
  const T* dob = static_cast<const T*>(a.dout) + qhead;
  const T* kb = static_cast<const T*>(a.k) + khead;
  const T* vb = static_cast<const T*>(a.v) + khead;

  // D_i = rowsum(dO_i * O_i): O staged over the K and V tiles (64 rows)
  fb_stage<T, D>(qb, qrs, q0, FB_BQ, a.Sq, Qs, LD);
  fb_stage<T, D>(dob, qrs, q0, FB_BQ, a.Sq, dOs, LD);
  fb_stage<T, D>(ob, qrs, q0, FB_BQ, a.Sq, Ks, LD);
  __syncthreads();
  float lse[4], dl[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty + 16 * r;
    float t = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      t = fmaf(dOs[row * LD + tx + 16 * c], Ks[row * LD + tx + 16 * c], t);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      t += __shfl_xor_sync(0xffffffffu, t, off, 16);
    dl[r] = t;
    const int qrow = q0 + row;
    lse[r] = qrow < a.Sq ? a.lse[((long long)b * a.Sq + qrow) * a.H + h] : 0.f;
    if (tx == 0 && qrow < a.Sq)
      a.dl[((long long)b * a.H + h) * a.Sq + qrow] = t;
  }

  const int q_offset = a.Sk - a.Sq;
  const int qp_lo = q_offset + q0;
  const int qp_hi = q_offset + min(q0 + FB_BQ, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, qp_hi + 1) : a.Sk;
  const int k_begin =
      a.window > 0 ? max(0, qp_lo - a.window + 1) / FB_BK * FB_BK : 0;

  float dq[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[r][c] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += FB_BK) {
    __syncthreads();  // O, or the last tile's K, V and ds, are read
    fb_stage<T, D>(kb, krs, k0, FB_BK, a.Sk, Ks, LD);
    fb_stage<T, D>(vb, krs, k0, FB_BK, a.Sk, Vs, LD);
    __syncthreads();

    // s = q k^T and dp = dO v^T for rows ty + 16 r, keys tx + 16 c
    float s[4][2], dp[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kv[2], vv[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        kv[c] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * c) * LD + d);
        vv[c] = *reinterpret_cast<const float4*>(Vs + (tx + 16 * c) * LD + d);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(Qs + (ty + 16 * r) * LD + d);
        const float4 gv =
            *reinterpret_cast<const float4*>(dOs + (ty + 16 * r) * LD + d);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          s[r][c] = dot4(qv, kv[c], s[r][c]);
          dp[r][c] = dot4(gv, vv[c], dp[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = qp_lo + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = fb_visible(a, qpos, k0 + tx + 16 * c)
                            ? expf(s[r][c] * a.scale - lse[r])
                            : 0.f;
        const float ds = p * (dp[r][c] - dl[r]) * a.scale;
        dSs[(ty + 16 * r) * LDP + tx + 16 * c] = fb_round(ds, T());
      }
    }
    __syncthreads();

    // dq += ds k for rows ty + 16 r, columns tx + 16 c
#pragma unroll 4
    for (int j = 0; j < FB_BK; ++j) {
      float kr[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kr[c] = Ks[j * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float w = dSs[(ty + 16 * r) * LDP + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) dq[r][c] = fmaf(w, kr[c], dq[r][c]);
      }
    }
  }

  T* dqb = static_cast<T*>(a.dq) + qhead;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= a.Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      fb_store(dqb + (long long)row * qrs + tx + 16 * c, dq[r][c]);
  }
}

// ---- pass 2: dk and dv -----------------------------------------------------

template <class T, int D, int R>
__global__ void __launch_bounds__(FB_THREADS)
    fa_bwd_dkv_kernel(const FbArgs a) {
  constexpr int BK = 16 * R;       // keys of one CTA
  constexpr int LD = D + 4;
  constexpr int LDP = FB_BQ2 + 4;  // p and ds tile row pitch
  constexpr int NC = D / 16;       // dk / dv columns per thread
  extern __shared__ float4 fb_smem[];
  float* Ks = reinterpret_cast<float*>(fb_smem);  // [BK][LD]
  float* Vs = Ks + BK * LD;                       // [BK][LD]
  float* Qs = Vs + BK * LD;                       // [FB_BQ2][LD]
  float* dOs = Qs + FB_BQ2 * LD;                  // [FB_BQ2][LD]
  float* Ps = dOs + FB_BQ2 * LD;                  // [BK][LDP]
  float* dSs = Ps + BK * LDP;                     // [BK][LDP]
  float* lse_s = dSs + BK * LDP;                  // [FB_BQ2]
  float* dl_s = lse_s + FB_BQ2;                   // [FB_BQ2]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // the first key tiles are seen by the most q rows under the causal mask
  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / a.KH, kvh = blockIdx.y % a.KH;
  const long long qrs = (long long)a.H * D, krs = (long long)a.KH * D;
  const long long khead = ((long long)b * a.Sk * a.KH + kvh) * D;
  fb_stage<T, D>(static_cast<const T*>(a.k) + khead, krs, k0, BK, a.Sk, Ks,
                 LD);
  fb_stage<T, D>(static_cast<const T*>(a.v) + khead, krs, k0, BK, a.Sk, Vs,
                 LD);

  // the q rows that can see a key of this tile
  const int q_offset = a.Sk - a.Sq;
  const int q_lo = a.causal ? max(0, k0 - q_offset) / FB_BQ2 * FB_BQ2 : 0;
  const int q_hi =
      a.window > 0 ? min(a.Sq, k0 + BK - 1 + a.window - q_offset) : a.Sq;

  float dk[R][NC], dv[R][NC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[r][c] = dv[r][c] = 0.f;

  for (int g = 0; g < a.G; ++g) {
    const int h = kvh * a.G + g;
    const long long qhead = ((long long)b * a.Sq * a.H + h) * D;
    const T* qb = static_cast<const T*>(a.q) + qhead;
    const T* dob = static_cast<const T*>(a.dout) + qhead;
    for (int q0 = q_lo; q0 < q_hi; q0 += FB_BQ2) {
      __syncthreads();  // the last q tile's Q, dO, p and ds are read
      fb_stage<T, D>(qb, qrs, q0, FB_BQ2, a.Sq, Qs, LD);
      fb_stage<T, D>(dob, qrs, q0, FB_BQ2, a.Sq, dOs, LD);
      if (threadIdx.x < FB_BQ2) {
        const int qrow = q0 + threadIdx.x;
        const bool in = qrow < a.Sq;
        lse_s[threadIdx.x] =
            in ? a.lse[((long long)b * a.Sq + qrow) * a.H + h] : 0.f;
        dl_s[threadIdx.x] =
            in ? a.dl[((long long)b * a.H + h) * a.Sq + qrow] : 0.f;
      }
      __syncthreads();

      // s^T = k q^T and dp^T = v dO^T for keys ty + 16 r, rows tx + 16 c
      float s[R][2], dp[R][2];
#pragma unroll
      for (int r = 0; r < R; ++r)
        s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        float4 qv[2], gv[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          qv[c] = *reinterpret_cast<const float4*>(Qs + (tx + 16 * c) * LD + d);
          gv[c] =
              *reinterpret_cast<const float4*>(dOs + (tx + 16 * c) * LD + d);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 kv =
              *reinterpret_cast<const float4*>(Ks + (ty + 16 * r) * LD + d);
          const float4 vv =
              *reinterpret_cast<const float4*>(Vs + (ty + 16 * r) * LD + d);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            s[r][c] = dot4(qv[c], kv, s[r][c]);
            dp[r][c] = dot4(gv[c], vv, dp[r][c]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int kpos = k0 + ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qi = tx + 16 * c, qrow = q0 + qi;
          const float p = qrow < a.Sq && fb_visible(a, q_offset + qrow, kpos)
                              ? expf(s[r][c] * a.scale - lse_s[qi])
                              : 0.f;
          const float ds = p * (dp[r][c] - dl_s[qi]) * a.scale;
          Ps[(ty + 16 * r) * LDP + qi] = fb_round(p, T());
          dSs[(ty + 16 * r) * LDP + qi] = fb_round(ds, T());
        }
      }
      __syncthreads();

      // dv += p^T dO, dk += ds^T q for keys ty + 16 r, columns tx + 16 c
#pragma unroll 4
      for (int i = 0; i < FB_BQ2; ++i) {
        float gr[NC], qr[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          gr[c] = dOs[i * LD + tx + 16 * c];
          qr[c] = Qs[i * LD + tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float p = Ps[(ty + 16 * r) * LDP + i];
          const float ds = dSs[(ty + 16 * r) * LDP + i];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv[r][c] = fmaf(p, gr[c], dv[r][c]);
            dk[r][c] = fmaf(ds, qr[c], dk[r][c]);
          }
        }
      }
    }
  }

  T* dkb = static_cast<T*>(a.dk) + khead;
  T* dvb = static_cast<T*>(a.dv) + khead;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int key = k0 + ty + 16 * r;
    if (key >= a.Sk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      fb_store(dkb + (long long)key * krs + tx + 16 * c, dk[r][c]);
      fb_store(dvb + (long long)key * krs + tx + 16 * c, dv[r][c]);
    }
  }
}

// ---- host side ---------------------------------------------------------------

template <class T, int D>
static int fb_launch(const FbArgs& a, int B, cudaStream_t stream) {
  constexpr int R = D > 128 ? 2 : 4;  // D = 256: 32 keys, dk + dv in 64 regs
  constexpr int smem1 = fb_dq_smem<D>();
  constexpr int smem2 = fb_dkv_smem<D, R>();
  static_assert(smem1 <= RT_SMEM_BYTES && smem2 <= RT_SMEM_BYTES,
                "flash_attention_bwd tile too large");
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fa_bwd_dkv_kernel<T, D, R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem2);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid1((a.Sq + FB_BQ - 1) / FB_BQ, B * a.H);
  fa_bwd_dq_kernel<T, D><<<grid1, FB_THREADS, smem1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2((a.Sk + 16 * R - 1) / (16 * R), B * a.KH);
  fa_bwd_dkv_kernel<T, D, R><<<grid2, FB_THREADS, smem2, stream>>>(a);
  return (int)cudaGetLastError();
}

template <class T>
static int fb_dispatch(const FbArgs& a, int B, int D, cudaStream_t s) {
  switch (D) {
    case 16: return fb_launch<T, 16>(a, B, s);
    case 64: return fb_launch<T, 64>(a, B, s);
    case 96: return fb_launch<T, 96>(a, B, s);
    case 128: return fb_launch<T, 128>(a, B, s);
    case 256: return fb_launch<T, 256>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Both passes, in order on `stream`.  dtype of q, k, v, out, dout, dq, dk, dv:
// 0 = float32, 1 = bfloat16; lse and dl float32; every tensor contiguous.
extern "C" int rt_flash_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const float* lse,
                                      void* dq, void* dk, void* dv, float* dl,
                                      int B, int Sq, int Sk, int H, int KH,
                                      int D, int dtype, float scale,
                                      int causal, int window, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KH < 1 || H % KH != 0 ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  FbArgs a{q, k, v, o, dout, lse, dq, dk, dv, dl, H, KH, H / KH, Sq, Sk,
           scale, causal, window};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return fb_dispatch<float>(a, B, D, s);
    case 1: return fb_dispatch<__nv_bfloat16>(a, B, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
