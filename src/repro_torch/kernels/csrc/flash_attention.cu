// flash_attention, fp32: causal / sliding-window GQA attention forward with
// an online softmax, fp32 in, fp32 accumulators, fp32 out.  bf16 inputs go to
// the tensor-core kernel of flash_attention_tc.cu.
//
// Replaces the fp32 path of repro/kernels/flash_attention.py::flash_attention
// (pallas_call at flash_attention.py:98, body _fa_kernel).  The TPU kernel
// runs a grid (B*KH*G, q blocks, kv blocks) whose kv axis is sequential,
// carrying m, l and the accumulator in VMEM scratch from one kv step to the
// next.  Here one CTA owns one (batch, q head, 64-row q tile), four warps of
// 16 rows; a loop inside the CTA over 32-key tiles takes the place of the
// sequential kv axis, with m, l and the accumulator in fp32 registers.  The
// GQA fold maps q head h to kv head h / G.  q, k and v are read through
// their [B, S, H, D] strides (no transposes).
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
// Bound on the H100: operations.  Both products run on the tensor cores in
// split TF32 (split_tf32.cuh: three TF32 mma.sync products per fp32
// product, an fp32 FMA loop's accuracy), so the bound is 3 x 4 D FLOPs per
// visible (q, k) pair at the 495 TFLOP/s of dense TF32.  S = Q K^T and
// O += P V are m16n8k8 products: Q and K fragments by ldmatrix from fp32
// tiles, P straight from S's registers (its key index permuted), V by
// scalar loads of rows 2t, 2t + 1.  Each k-step of S folds into fp32
// registers; P V chains its big and small products apart over the tile
// and folds them into the accumulator with the rescale (acc * corr +
// tile), so no tensor-core sum runs past one tile.  Only tiles that
// straddle the diagonal, the window's edge or Sk compute the mask.  K and V
// tiles come through a two-stage cp.async ring, the next tile in flight
// while the current one computes.  The softmax stays fp32 with expf.
#include "abi.cuh"
#include "split_tf32.cuh"

#define FA_BQ RT_FA_BQ   // q rows of one CTA, 16 a warp
#define FA_BK RT_FA_BK   // keys of one kv tile
#define FA_THREADS 128
#define FA_NEG_INF (-1e30f)

// row pitch of every tile, in floats: ldmatrix rows and the rows 2t of
// c_operand_b fall on distinct banks
template <int D>
__host__ __device__ constexpr int fa_ld() {
  return D + 4;
}

template <int D>
constexpr int fa_smem_bytes() {
  return 4 * (FA_BQ + 4 * FA_BK) * fa_ld<D>();
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
__global__ void __launch_bounds__(FA_THREADS, 2)
    fa_fwd_kernel(const FaArgs a) {
  constexpr int LD = fa_ld<D>();
  constexpr int NS = FA_BK / 8;  // 8-key column tiles of S
  constexpr int NO = D / 8;      // 8-column tiles of O
  extern __shared__ float4 fa_smem[];
  float* Qs = reinterpret_cast<float*>(fa_smem);  // [FA_BQ][LD]
  float* Ks = Qs + FA_BQ * LD;                    // [2][FA_BK][LD]
  float* Vs = Ks + 2 * FA_BK * LD;                // [2][FA_BK][LD]

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's first row
  // the last q tiles see the most keys under the causal mask: launch them
  // first, every head's, so that the short tiles fill the tail
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H, kvh = h / a.G;
  const int q0 = qt * FA_BQ;
  const float* qb = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + kvh * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + kvh * a.vsh;
  float* ob = static_cast<float*>(a.o) + b * a.osb + h * a.osh;

  // the kv tiles any row of this q tile can see
  const int q_offset = a.Sk - a.Sq;
  const int qp_lo = q_offset + q0;
  const int qp_hi = q_offset + min(q0 + FA_BQ, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, qp_hi + 1) : a.Sk;
  const int k_begin =
      a.window > 0 ? max(0, qp_lo - a.window + 1) / FA_BK * FA_BK : 0;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + FA_BK - 1) / FA_BK
                                     : 0;

  stage_rows_async<D>(qb, a.qss, q0, FA_BQ, a.Sq, Qs, LD, FA_THREADS);
  if (ntiles > 0) {
    stage_rows_async<D>(kb, a.kss, k_begin, FA_BK, a.Sk, Ks, LD, FA_THREADS);
    stage_rows_async<D>(vb, a.vss, k_begin, FA_BK, a.Sk, Vs, LD, FA_THREADS);
  }
  cp_async_commit();

  // rows wr + g (r = 0) and wr + g + 8 (r = 1) of the tile
  float m[2] = {FA_NEG_INF, FA_NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = k_begin + it * FA_BK;
    const float* Kt = Ks + (it & 1) * FA_BK * LD;
    const float* Vt = Vs + (it & 1) * FA_BK * LD;
    __syncthreads();  // the other stage's last reads are done
    if (it + 1 < ntiles) {
      float* nk = Ks + ((it + 1) & 1) * FA_BK * LD;
      float* nv = Vs + ((it + 1) & 1) * FA_BK * LD;
      stage_rows_async<D>(kb, a.kss, k0 + FA_BK, FA_BK, a.Sk, nk, LD,
                          FA_THREADS);
      stage_rows_async<D>(vb, a.vss, k0 + FA_BK, FA_BK, a.Sk, nv, LD,
                          FA_THREADS);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) landed; the next may fly
    __syncthreads();

    // S = Q K^T for the warp's 16 rows and the tile's keys, each k-step's
    // three products folded into fp32
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D; kk += 8) {
      uint32_t ahi[4], alo[4];
      load_a_split(Qs, LD, wr, kk, ahi, alo);
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t bhi[4], blo[4];
        load_b2_split(Kt, LD, n * 8, kk, bhi, blo);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          mma_split(c, c, ahi, alo, bhi + 2 * j, blo + 2 * j);
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n + j][e] += c[e];
        }
      }
    }

    // mask (only where the tile holds a key some row of the warp must not
    // see), online softmax; the quad of lanes 4g .. 4g + 3 holds a row
    const bool whole = k0 + FA_BK <= a.Sk &&
                       (!a.causal || k0 + FA_BK - 1 <= qp_lo + wr) &&
                       (a.window <= 0 || qp_lo + wr + 15 - k0 < a.window);
    float mx[2] = {FA_NEG_INF, FA_NEG_INF};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool ok = true;
        if (!whole) {
          const int qpos = qp_lo + wr + g + (e >> 1) * 8;
          const int kpos = k0 + n * 8 + 2 * t + (e & 1);
          ok = kpos < a.Sk;
          if (a.causal) ok = ok && qpos >= kpos;
          if (a.window > 0) ok = ok && (qpos - kpos) < a.window;
        }
        s[n][e] = ok ? s[n][e] * a.scale : FA_NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    uint32_t phi[NS][4], plo[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
      c_as_a_split(s[n], phi[n], plo[n]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }

    // acc = acc * corr + P V, one 8-column tile at a time
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      float c[4] = {0.f, 0.f, 0.f, 0.f}, cl[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t bhi[2], blo[2];
        c_operand_b(Vt, LD, j * 8, n * 8, bhi, blo);
        mma_split(c, cl, phi[j], plo[j], bhi, blo);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = fmaf(acc[n][e], corr[e >> 1], c[e] + cl[e]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    if (row >= a.Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    float* orow = ob + (long long)row * a.oss + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(orow + n * 8) =
          make_float2(acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
    if (a.lse && t == 0)
      a.lse[((long long)b * a.Sq + row) * a.H + h] = m[r] + logf(den);
  }
}

template <int D>
static int fa_launch(const FaArgs& a, int B, cudaStream_t stream) {
  constexpr int smem = fa_smem_bytes<D>();
  static_assert(smem <= RT_SMEM_BYTES, "flash_attention tile too large");
  static_assert(FA_BQ == 64 && FA_BK % 16 == 0, "four 16-row warps");
  // opting in above 48 KB is per kernel; a repeat is cheap
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * a.H, (a.Sq + FA_BQ - 1) / FA_BQ);
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
