// ssd_scan: the Mamba2 inter-chunk state recurrence
//     S_c = decay_c * S_{c-1} + states_c,   prev_c = S_{c-1},   S_{-1} = 0,
// states [BH, NC, P, N] (fp32, bf16 or fp16), decay [BH, NC] fp32 -> prev
// [BH, NC, P, N] fp32.
//
// Replaces repro/kernels/ssd_scan.py::ssd_scan (pallas_call at
// ssd_scan.py:44, body _ssd_kernel).  The TPU kernel runs a grid (BH, NC)
// whose chunk axis is sequential and keeps S in VMEM scratch across it.  Here
// one thread owns one (bh, p, n) element and loops over the NC chunks with S
// in a register: the loop takes the place of the sequential grid axis and
// the register that of the scratch.  Each step stores S_{c-1} before the
// update and reads the chunk's decay once (one address for every thread of
// a warp that shares bh).  The multiply and the add are rounded separately
// (__fmul_rn, __fadd_rn), as the plain version's two torch ops are, so the
// kernel and its plain version agree bit for bit.
//
// Bound on the H100: by bytes.  At the mamba2-2.7b shape (B = 2, S = 4,096,
// chunk 128: BH = 160, NC = 32, P = 64, N = 128) it moves 168 MB of states
// in and 168 MB of prev out at 3.35 TB/s (~0.10 ms) for 2 flops an element.
// Neighbouring threads take neighbouring (p, n), so every load and store is
// coalesced.  Triton would serve as well (a pure recurrence over elementwise
// work); it stays CUDA to keep one build route for the port's kernels.
//
// ssd_scan_bwd_kernel, its backward (no Pallas counterpart: the reference
// differentiates the recurrence as a lax.scan through XLA).  With G_c the
// gradient of S_c,
//     G_{NC-1} = 0,   G_c = dprev_{c+1} + decay_{c+1} * G_{c+1},
//     dstates_c = G_c,   ddecay_c = sum over (p, n) of G_c * prev_c.
// One CTA of 1,024 threads owns one bh and scans its chunks backwards, each
// thread keeping G of EPT elements in registers (multiply and add rounded
// separately, as the plain version's torch ops are, so dstates is bit for bit
// the plain version's).  ddecay_c is reduced inside the CTA, with no atomics:
// a warp sums its threads' shares by shuffles and writes them to a [NC, 32]
// shared array, which 32 lanes add in warp order after the scan.  Bound on
// the H100: bytes.  At the mamba2-2.7b training shape (B = 1, S = 4,096:
// [80, 32, 64, 128]) dprev and prev are read and dstates written once, ~252
// MB in fp32: 0.075 ms at 3.35 TB/s.
#include "abi.cuh"

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#define SSD_THREADS 256

__device__ __forceinline__ float ssd_to_f(float x) { return x; }
__device__ __forceinline__ float ssd_to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float ssd_to_f(__half x) { return __half2float(x); }

template <class T>
__global__ void __launch_bounds__(SSD_THREADS)
    ssd_scan_kernel(const T* __restrict__ states,
                    const float* __restrict__ decay, float* __restrict__ prev,
                    long long BH, int NC, long long PN) {
  const long long i = (long long)blockIdx.x * SSD_THREADS + threadIdx.x;
  if (i >= BH * PN) return;
  const long long bh = i / PN, e = i - bh * PN;
  const T* st = states + bh * NC * PN + e;
  float* pv = prev + bh * NC * PN + e;
  const float* d = decay + bh * NC;
  float s = 0.f;
#pragma unroll 8
  for (int c = 0; c < NC; ++c) {
    pv[c * PN] = s;
    s = __fadd_rn(__fmul_rn(s, __ldg(d + c)), ssd_to_f(st[c * PN]));
  }
}

#define SSDB_THREADS 1024
#define SSDB_WARPS (SSDB_THREADS / 32)

__device__ __forceinline__ void ssd_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void ssd_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void ssd_store(__half* p, float x) {
  *p = __float2half(x);
}

template <class T, int EPT>
__global__ void __launch_bounds__(SSDB_THREADS)
    ssd_scan_bwd_kernel(const float* __restrict__ dprev,
                        const float* __restrict__ prev,
                        const float* __restrict__ decay,
                        T* __restrict__ dstates, float* __restrict__ ddecay,
                        int NC, long long PN) {
  extern __shared__ float ssdb_red[];  // [NC][SSDB_WARPS]
  const long long bh = blockIdx.x;
  const float* dp = dprev + bh * NC * PN;
  const float* pv = prev + bh * NC * PN;
  const float* d = decay + bh * NC;
  T* ds = dstates + bh * NC * PN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float g[EPT];
#pragma unroll
  for (int j = 0; j < EPT; ++j) g[j] = 0.f;
  for (int c = NC - 1; c >= 0; --c) {
    float part = 0.f;
    const float dn = c + 1 < NC ? __ldg(d + c + 1) : 0.f;
#pragma unroll
    for (int j = 0; j < EPT; ++j) {
      const long long e = threadIdx.x + (long long)j * SSDB_THREADS;
      if (e < PN) {
        if (c + 1 < NC)
          g[j] = __fadd_rn(dp[(c + 1) * PN + e], __fmul_rn(dn, g[j]));
        ssd_store(ds + c * PN + e, g[j]);
        part = fmaf(g[j], pv[c * PN + e], part);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) ssdb_red[c * SSDB_WARPS + warp] = part;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < NC; c += SSDB_THREADS) {
    float t = 0.f;
    for (int w = 0; w < SSDB_WARPS; ++w) t += ssdb_red[c * SSDB_WARPS + w];
    ddecay[bh * NC + c] = t;
  }
}

template <class T>
static int ssdb_launch(const float* dprev, const float* prev,
                       const float* decay, void* dstates, float* ddecay,
                       long long BH, int NC, long long PN, cudaStream_t s) {
  const int smem = NC * SSDB_WARPS * 4;
  const long long ept = (PN + SSDB_THREADS - 1) / SSDB_THREADS;
#define SSDB_CASE(E)                                                        \
  if (ept <= E) {                                                           \
    cudaError_t err = cudaFuncSetAttribute(                                 \
        ssd_scan_bwd_kernel<T, E>,                                          \
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);                 \
    if (err != cudaSuccess) return (int)err;                                \
    ssd_scan_bwd_kernel<T, E><<<(unsigned)BH, SSDB_THREADS, smem, s>>>(     \
        dprev, prev, decay, static_cast<T*>(dstates), ddecay, NC, PN);      \
    return (int)cudaGetLastError();                                         \
  }
  SSDB_CASE(1)
  SSDB_CASE(2)
  SSDB_CASE(4)
  SSDB_CASE(8)
  SSDB_CASE(16)
  SSDB_CASE(32)
#undef SSDB_CASE
  return (int)cudaErrorInvalidValue;
}

// The backward: dprev, prev [BH, NC, PN] and decay [BH, NC] fp32 ->
// dstates [BH, NC, PN] (dtype as rt_ssd_scan's states) and ddecay [BH, NC]
// fp32.  PN <= 32,768 and NC <= RT_SSDB_MAX_NC.
extern "C" int rt_ssd_scan_bwd(const float* dprev, const float* prev,
                               const float* decay, void* dstates,
                               float* ddecay, int dtype, long long BH, int NC,
                               long long PN, void* stream) {
  if (BH < 0 || NC < 0 || PN < 0 || PN > 32 * SSDB_THREADS ||
      NC > RT_SSDB_MAX_NC || BH > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || NC == 0 || PN == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return ssdb_launch<float>(dprev, prev, decay, dstates, ddecay, BH, NC,
                                PN, s);
    case 1:
      return ssdb_launch<__nv_bfloat16>(dprev, prev, decay, dstates, ddecay,
                                        BH, NC, PN, s);
    case 2:
      return ssdb_launch<__half>(dprev, prev, decay, dstates, ddecay, BH, NC,
                                 PN, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dtype of states: 0 = float32, 1 = bfloat16, 2 = float16.
extern "C" int rt_ssd_scan(const void* states, const float* decay,
                           float* prev, int dtype, long long BH, int NC,
                           long long PN, void* stream) {
  if (BH < 0 || NC < 0 || PN < 0) return (int)cudaErrorInvalidValue;
  if (BH == 0 || NC == 0 || PN == 0) return 0;
  const long long n = BH * PN;
  const long long blocks = (n + SSD_THREADS - 1) / SSD_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      ssd_scan_kernel<float><<<(unsigned)blocks, SSD_THREADS, 0, s>>>(
          static_cast<const float*>(states), decay, prev, BH, NC, PN);
      break;
    case 1:
      ssd_scan_kernel<__nv_bfloat16><<<(unsigned)blocks, SSD_THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(states), decay, prev, BH, NC, PN);
      break;
    case 2:
      ssd_scan_kernel<__half><<<(unsigned)blocks, SSD_THREADS, 0, s>>>(
          static_cast<const __half*>(states), decay, prev, BH, NC, PN);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
