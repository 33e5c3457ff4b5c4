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
// work is bound by bytes (the weight), and at this size by the launch.  The
// kernel is a plain SIMT tile: a 16 x 64 output tile per CTA, K stepped
// through shared memory bk at a time (bk from the segment's MM parallelism),
// every FMA in fp32 (no TF32: w0 = 30 amplifies its lost digits).  Ragged M,
// N and K are masked (the path has K in {1, 2} and N in {1, 2}).
#include "abi.cuh"

#define MM_TM 16
#define MM_TN 64
#define MM_TK 32
#define MM_THREADS 256

__global__ void __launch_bounds__(MM_THREADS)
    matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  const float* __restrict__ bias, float* __restrict__ C, int M,
                  int N, int K, int bk, float w0, int apply_sin) {
  __shared__ float As[MM_TK][MM_TM];
  __shared__ float Bs[MM_TK][MM_TN];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // one row, four columns a thread
  const int m0 = blockIdx.y * MM_TM, n0 = blockIdx.x * MM_TN;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += bk) {
    for (int i = tid; i < MM_TM * bk; i += MM_THREADS) {
      const int m = i / bk, k = i % bk;
      As[k][m] = (m0 + m < M && k0 + k < K)
                     ? A[(long long)(m0 + m) * K + k0 + k] : 0.f;
    }
    for (int i = tid; i < bk * MM_TN; i += MM_THREADS) {
      const int k = i / MM_TN, n = i % MM_TN;
      Bs[k][n] = (k0 + k < K && n0 + n < N)
                     ? B[(long long)(k0 + k) * N + n0 + n] : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < bk; ++k) {
      const float a = As[k][ty];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(a, Bs[k][tx + 16 * j], acc[j]);
    }
    __syncthreads();
  }
  const int m = m0 + ty;
  if (m >= M) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= N) continue;
    float h = acc[j];
    if (bias) h += bias[n];
    if (apply_sin) h = sinf(w0 * h);
    C[(long long)m * N + n] = h;
  }
}

extern "C" int rt_matmul(const float* A, const float* B, const float* bias,
                         float* C, int M, int N, int K, int bk, float w0,
                         int apply_sin, void* stream) {
  if (bk < 1 || bk > MM_TK || M < 0 || N < 0 || K < 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + MM_TN - 1) / MM_TN, (M + MM_TM - 1) / MM_TM);
  matmul_kernel<<<grid, MM_THREADS, 0, (cudaStream_t)stream>>>(
      A, B, bias, C, M, N, K, bk, w0, apply_sin);
  return (int)cudaGetLastError();
}
