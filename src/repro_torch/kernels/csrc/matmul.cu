// matmul: C = A @ B  [+ bias]  [-> sin(w0 * .)], fp32 in, fp32 accumulate.
//
// Replaces two TPU kernels: repro/kernels/stream_matmul.py::stream_matmul
// (pallas_call at stream_matmul.py:70) and
// repro/kernels/siren_layer.py::siren_layer (pallas_call at siren_layer.py:64),
// which differ only in the epilogue: siren_layer adds the bias and applies
// sin(w0 .) to the accumulator before it is written, so x@W+b never reaches
// device memory.
//
// On the main path A is one 8-row block and B a resident weight of at most
// 256 x 256: 2 * 8 * 256 * 256 = 1 MFLOP against 256 KB of weight, so the
// work is bound by bytes (the weight), and at this size by the latency of
// one read of it.  So the weight read is spread over the card: one CTA per
// 8 x 8 output tile (32 CTAs at N = 256), each of whose 256 threads issues
// all of its loads of a 256-row K chunk (A's rows and the weight's 8-column
// slab) before its first FMA.  The K chunk is split over the CTA's 8 warps,
// 32 rows each, every lane owning one row and two columns; the 8 partial
// sums are added in warp order in shared memory (deterministic, no atomics).
// Every FMA is fp32 (no TF32: w0 = 30 amplifies its lost digits).  Ragged M,
// N and K are masked (the path has K in {1, 2} and N in {1, 2}).
#include "abi.cuh"

#define MM_TM 8        // rows of one CTA's tile
#define MM_TN 8        // columns of one CTA's tile
#define MM_KC 256      // K rows staged at a time
#define MM_THREADS 256
#define MM_WARPS (MM_THREADS / 32)
#define MM_KW (MM_KC / MM_WARPS)   // K rows of one warp's partial sum
#define MM_LOADS (MM_TM * MM_KC / MM_THREADS)  // loads of A (and of B) a thread
#define MM_MAX_BK 32   // largest K step a caller may name (stream_matmul.py)

static_assert(MM_TM * MM_TN == 2 * 32, "a lane owns one row, two columns");
static_assert(MM_KC * MM_TN == MM_TM * MM_KC, "A and B chunks load alike");

__global__ void __launch_bounds__(MM_THREADS)
    matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  const float* __restrict__ bias, float* __restrict__ C, int M,
                  int N, int K, int n_tiles, float w0, int apply_sin) {
  __shared__ float As[MM_TM][MM_KC + 1];  // padded: 8 rows on 8 banks
  __shared__ float Bs[MM_KC][MM_TN];
  __shared__ float part[MM_WARPS][MM_TM * MM_TN];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x / n_tiles * MM_TM;
  const int n0 = blockIdx.x % n_tiles * MM_TN;
  const int lm = lane / 4, ln = 2 * (lane % 4);  // this lane's row, columns
  float acc0 = 0.f, acc1 = 0.f;
  for (int kc = 0; kc < K; kc += MM_KC) {
    float av[MM_LOADS], bv[MM_LOADS];
#pragma unroll
    for (int j = 0; j < MM_LOADS; ++j) {
      const int i = tid + j * MM_THREADS;
      const int am = i / MM_KC, ak = kc + i % MM_KC;
      const int bk = kc + i / MM_TN, bn = n0 + i % MM_TN;
      av[j] = m0 + am < M && ak < K ? A[(long long)(m0 + am) * K + ak] : 0.f;
      bv[j] = bk < K && bn < N ? B[(long long)bk * N + bn] : 0.f;
    }
    if (kc > 0) __syncthreads();  // the last chunk's reads are done
#pragma unroll
    for (int j = 0; j < MM_LOADS; ++j) {
      const int i = tid + j * MM_THREADS;
      As[i / MM_KC][i % MM_KC] = av[j];
      Bs[i / MM_TN][i % MM_TN] = bv[j];
    }
    __syncthreads();
#pragma unroll 8
    for (int k = warp * MM_KW; k < (warp + 1) * MM_KW; ++k) {
      const float a = As[lm][k];
      acc0 = fmaf(a, Bs[k][ln], acc0);
      acc1 = fmaf(a, Bs[k][ln + 1], acc1);
    }
  }
  part[warp][lm * MM_TN + ln] = acc0;
  part[warp][lm * MM_TN + ln + 1] = acc1;
  __syncthreads();
  if (tid >= MM_TM * MM_TN) return;
  const int m = m0 + tid / MM_TN, n = n0 + tid % MM_TN;
  if (m >= M || n >= N) return;
  float h = part[0][tid];
#pragma unroll
  for (int w = 1; w < MM_WARPS; ++w) h += part[w][tid];
  if (bias) h += bias[n];
  if (apply_sin) h = sinf(w0 * h);
  C[(long long)m * N + n] = h;
}

// bk, the reduction step the segment's MM parallelism names, is checked and
// otherwise unused: the kernel's tile is fixed.
extern "C" int rt_matmul(const float* A, const float* B, const float* bias,
                         float* C, int M, int N, int K, int bk, float w0,
                         int apply_sin, void* stream) {
  if (bk < 1 || bk > MM_MAX_BK || M < 0 || N < 0 || K < 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const long long n_tiles = (N + MM_TN - 1) / MM_TN;
  const long long tiles = (M + MM_TM - 1) / MM_TM * n_tiles;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  matmul_kernel<<<(unsigned)tiles, MM_THREADS, 0, (cudaStream_t)stream>>>(
      A, B, bias, C, M, N, K, (int)n_tiles, w0, apply_sin);
  return (int)cudaGetLastError();
}
