// flash_attention, fp32: causal / sliding-window GQA attention forward with
// an online softmax, fp32 in, fp32 accumulators, fp32 out.  bf16 inputs go to
// the tensor-core kernel of flash_attention_tc.cu.
//
// Replaces the fp32 path of repro/kernels/flash_attention.py::flash_attention
// (pallas_call at flash_attention.py:98, body _fa_kernel).  The TPU kernel
// runs a grid (B*KH*G, q blocks, kv blocks) whose kv axis is sequential,
// carrying m, l and the accumulator in VMEM scratch from one kv step to the
// next.  Here one CTA owns one (batch, q head, 64-row q tile); a loop inside
// the CTA over 32-key tiles takes the place of the sequential kv axis, with
// m, l and the accumulator in fp32 registers.  The GQA fold maps q head h to
// kv head h / G.  q, k and v are read through their [B, S, H, D] strides (no
// transposes).
//
// Masks follow the TPU kernel: keys past Sk, causal q_pos >= k_pos with
// q_pos = (Sk - Sq) + i, window q_pos - k_pos < window; masked scores are
// -1e30.  The output is acc / max(l, 1e-30); given a pointer, the kernel also
// writes each row's log-sum-exp m + log(max(l, 1e-30)) as float32 [B, Sq, H],
// which the backward (flash_attention_bwd.cu) reads.  Kv tiles wholly outside the
// causal band or the window are skipped: such a tile adds exp(-1e30 - m) = 0
// after a visible one, and one before every visible tile is wiped by the
// first visible tile's correction exp(-1e30 - m) = 0, so skipping changes no
// result.  Rows with no visible key at all (Sq > Sk) give 0 here; nothing on
// the model path produces them.
//
// Bound on the H100: fp32 products stay off the tensor cores (TF32 keeps
// about three digits), so the bound is operations at the 67 TFLOP/s of fp32
// FMAs.  Every product is a SIMT fp32 FMA: a 4 x 2 score tile and a 4 x D/16
// output tile per thread, float4 shared-memory reads of q and k with rows
// padded by four floats so that eight rows of a quarter-warp fall on
// distinct banks.
#include "abi.cuh"

#define FA_BQ RT_FA_BQ   // q rows of one CTA
#define FA_BK RT_FA_BK   // keys of one kv tile
#define FA_THREADS 256   // 16 x 16: ty owns rows ty + 16 r, tx keys tx + 16 c
#define FA_NEG_INF (-1e30f)

// Stage rows [r0, r0 + rows) of one head of a [B, S, H, D] tensor (row
// stride ss elements, head base already applied) into shared memory with row
// pitch ld; rows at or past S are zero.  16-byte global loads.
template <int D>
__device__ __forceinline__ void stage_rows(const float* __restrict__ base,
                                           long long ss, int r0, int rows,
                                           int S, float* __restrict__ dst,
                                           int ld) {
  constexpr int VPR = D / 4;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < rows * VPR; i += FA_THREADS) {
    const int r = i / VPR, c = (i % VPR) * 4;
    *reinterpret_cast<float4*>(dst + r * ld + c) =
        r0 + r < S ? *reinterpret_cast<const float4*>(
                         base + (long long)(r0 + r) * ss + c)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int D>
constexpr int fa_smem_bytes() {
  return 4 * (FA_BQ * (D + 4) + FA_BK * (D + 4) + FA_BK * D +
              FA_BQ * (FA_BK + 4));
}

struct FaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, Sq, H] or null
  int H, G, Sq, Sk;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh;
  float scale;
  int causal, window;
};

template <int D>
__global__ void __launch_bounds__(FA_THREADS) fa_fwd_kernel(const FaArgs a) {
  constexpr int LDQ = D + 4;      // q and k tile row pitch (floats)
  constexpr int LDP = FA_BK + 4;  // P tile row pitch
  constexpr int NC = D / 16;      // output columns per thread
  extern __shared__ float4 fa_smem[];
  float* Qs = reinterpret_cast<float*>(fa_smem);  // [FA_BQ][LDQ]
  float* Ks = Qs + FA_BQ * LDQ;                   // [FA_BK][LDQ]
  float* Vs = Ks + FA_BK * LDQ;                   // [FA_BK][D]
  float* Ps = Vs + FA_BK * D;                     // [FA_BQ][LDP]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // the last q tiles see the most keys under the causal mask: launch them
  // first so that the short tiles fill the tail
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H, kvh = h / a.G;
  const int q0 = qt * FA_BQ;
  const float* qb = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + kvh * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + kvh * a.vsh;
  float* ob = static_cast<float*>(a.o) + b * a.osb + h * a.osh;

  stage_rows<D>(qb, a.qss, q0, FA_BQ, a.Sq, Qs, LDQ);

  // the kv tiles any row of this q tile can see
  const int q_offset = a.Sk - a.Sq;
  const int qp_lo = q_offset + q0;
  const int qp_hi = q_offset + min(q0 + FA_BQ, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, qp_hi + 1) : a.Sk;
  const int k_begin =
      a.window > 0 ? max(0, qp_lo - a.window + 1) / FA_BK * FA_BK : 0;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = FA_NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += FA_BK) {
    __syncthreads();  // the last tile's Ks, Vs and Ps are read
    stage_rows<D>(kb, a.kss, k0, FA_BK, a.Sk, Ks, LDQ);
    stage_rows<D>(vb, a.vss, k0, FA_BK, a.Sk, Vs, D);
    __syncthreads();

    // s = q k^T for rows ty + 16 r and keys tx, tx + 16
    float s[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[2];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * r) * LDQ + d);
#pragma unroll
      for (int c = 0; c < 2; ++c)
        kv[c] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * c) * LDQ + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float t = s[r][c];
          t = fmaf(qv[r].x, kv[c].x, t);
          t = fmaf(qv[r].y, kv[c].y, t);
          t = fmaf(qv[r].z, kv[c].z, t);
          t = fmaf(qv[r].w, kv[c].w, t);
          s[r][c] = t;
        }
    }

    // mask, online softmax; the 16 lanes of one ty hold one row's keys
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = qp_lo + ty + 16 * r;
      float mx = FA_NEG_INF;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = k0 + tx + 16 * c;
        bool ok = kpos < a.Sk;
        if (a.causal) ok = ok && qpos >= kpos;
        if (a.window > 0) ok = ok && (qpos - kpos) < a.window;
        s[r][c] = ok ? s[r][c] * a.scale : FA_NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      const float p0 = expf(s[r][0] - m_new), p1 = expf(s[r][1] - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off, 16);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
      float* prow = Ps + (ty + 16 * r) * LDP;
      prow[tx] = p0;
      prow[tx + 16] = p1;
    }
    __syncthreads();

    // acc += P V for rows ty + 16 r, columns tx + 16 c
#pragma unroll 2
    for (int j = 0; j < FA_BK; j += 4) {
      float4 p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[r] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * r) * LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = Vs + (j + jj) * D + tx;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float vv = vrow[16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float pr = jj == 0 ? p[r].x : jj == 1 ? p[r].y
                           : jj == 2 ? p[r].z : p[r].w;
            acc[r][c] = fmaf(pr, vv, acc[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= a.Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    float* orow = ob + (long long)row * a.oss + tx;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      orow[16 * c] = acc[r][c] / den;
    if (a.lse && tx == 0)
      a.lse[((long long)b * a.Sq + row) * a.H + h] = m[r] + logf(den);
  }
}

template <int D>
static int fa_launch(const FaArgs& a, int B, cudaStream_t stream) {
  constexpr int smem = fa_smem_bytes<D>();
  static_assert(smem <= RT_SMEM_BYTES, "flash_attention tile too large");
  // opting in above 48 KB is per kernel; a repeat is cheap
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + FA_BQ - 1) / FA_BQ, B * a.H);
  fa_fwd_kernel<D><<<grid, FA_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// fp32 q, k, v, out.  strides[12] = q, k, v, out strides of (batch, seq,
// head) in elements; the head dim is contiguous.  lse: contiguous float32
// [B, Sq, H], or null.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, float* lse, int B, int Sq, int Sk,
                                  int H, int KH, int D,
                                  const long long* strides,
                                  float scale, int causal, int window,
                                  void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KH < 1 || H % KH != 0 ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  FaArgs a{q, k, v, o, lse, H, H / KH, Sq, Sk,
           strides[0], strides[1], strides[2], strides[3], strides[4],
           strides[5], strides[6], strides[7], strides[8], strides[9],
           strides[10], strides[11], scale, causal, window};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return fa_launch<16>(a, B, s);
    case 64: return fa_launch<64>(a, B, s);
    case 96: return fa_launch<96>(a, B, s);
    case 128: return fa_launch<128>(a, B, s);
    case 256: return fa_launch<256>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
