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
