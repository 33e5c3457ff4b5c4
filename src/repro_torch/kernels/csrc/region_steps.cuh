// The step interpreter shared by region.cu (the forward) and region_bwd.cu
// (whose first pass replays the forward): the pointer table, views, and
// the chain and mm steps of a region program.  kernels/region.py writes
// the instruction tables these functions read.
#pragma once

#include "abi.cuh"

#define MM_UNROLL 8  // weight loads an mm thread keeps in flight
#define MM_XCHUNK (RT_RED_FLOATS / RT_REGION_ROWS)  // x columns staged at once

// The pointer table: each tensor's base and its per-lane stride in elements
// (all 0 for a single-lane launch).
struct LaneTable {
  const float* p[RT_MAX_PTRS];
  long long stride[RT_MAX_PTRS];
};

// Tensor i of the pointer table, as seen by lane `lane`.
__device__ __forceinline__ const float* tensor(const LaneTable& P, int i,
                                               long long lane) {
  return P.p[i] + lane * P.stride[i];
}

// A view is 5 ints: space (0 = a tensor of the pointer table, 1 = the CTA's
// workspace), index (pointer-table index or workspace offset in floats),
// row stride, column offset, column stride (0 broadcasts one column).
// Rows of a tensor view start at the CTA's first row; a row stride of 0
// broadcasts one [1, C] row.
__device__ __forceinline__ const float* view_base(const int* v,
                                                  const LaneTable& P,
                                                  const float* ws,
                                                  long long lane,
                                                  long long row0) {
  return v[0] ? ws + v[1] + v[3] : tensor(P, v[1], lane) + row0 * v[2] + v[3];
}

// Instruction layouts (RT_INSTR_INTS ints each); kernels/region.py writes them.
//   chain: [0]=0 [1]=cols [2]=n_ops [3]=ops offset (ints of prog)
//          [4]=constants offset (floats of fc) [5]=n_extra
//          [6..10]=out view [11..15]=x view [16+5e..]=extra view e
//   mm:    [0]=1 [1]=N [2]=K [3]=W pointer [4]=W row stride [5]=W first row
//          [6]=W first column [7]=bias pointer or -1 [8]=flags
//          (1 sin, 2 accumulate into out, 4 epilogue) [9]=w0 offset (fc)
//          [10..14]=out view [15..19]=x view
__device__ __forceinline__ void chain_step(const int* I, const int* prog,
                                           const float* fc, const LaneTable& P,
                                           float* ws, long long lane,
                                           long long row0, int rows) {
  // decode the step once into shared memory instead of once per element
  __shared__ int s_ops[RT_MAX_CHAIN];
  __shared__ float s_vals[RT_MAX_CHAIN];
  __shared__ const float* s_ext[RT_MAX_EXTRA];
  __shared__ int s_eld[RT_MAX_EXTRA], s_ecs[RT_MAX_EXTRA];
  const int C = I[1], n_ops = I[2], n_extra = I[5];
  const int t = threadIdx.x;
  if (t < n_ops) {
    s_ops[t] = prog[I[3] + t];
    s_vals[t] = fc[I[4] + t];
  }
  if (t < n_extra) {
    const int* v = I + 16 + 5 * t;
    s_ext[t] = view_base(v, P, ws, lane, row0);
    s_eld[t] = v[2];
    s_ecs[t] = v[4];
  }
  __syncthreads();
  const int* ov = I + 6;
  const int* xv = I + 11;
  float* ob = const_cast<float*>(view_base(ov, P, ws, lane, row0));
  const float* xb = view_base(xv, P, ws, lane, row0);
  const int old = ov[2], xld = xv[2], xcs = xv[4];
  for (int i = t; i < rows * C; i += blockDim.x) {
    const int r = i / C, c = i - r * C;
    const float h = eval_chain(xb[r * xld + c * xcs], n_ops, s_ops, s_vals,
                               [&](int e) {
                                 return s_ext[e][r * s_eld[e] + c * s_ecs[e]];
                               });
    ob[r * old + c] = h;
  }
}

// pw threads across output columns, ksplit more across K (at most a warp's
// worth, so the serial reduction below stays short).  A thread sums its k in
// order (k, k + ksplit, ...); the ksplit partial sums then add up in order
// through shared memory.  With kSavePre (the backward's replay), a sin
// epilogue also writes its argument's factor h (sin(w0 h)) to pre [rows, N].
template <bool kSavePre = false>
__device__ __forceinline__ void mm_step(const int* I, const float* fc,
                                        const LaneTable& P, float* ws,
                                        float* red, long long lane,
                                        long long row0, int rows,
                                        float* pre = nullptr) {
  const int N = I[1], K = I[2];
  const float* W = tensor(P, I[3], lane);
  const int ldw = I[4], k0 = I[5], n0 = I[6];
  const float* bias = I[7] >= 0 ? tensor(P, I[7], lane) + n0 : nullptr;
  const int flags = I[8];
  const float w0 = fc[I[9]];
  const int* ov = I + 10;
  const int* xv = I + 15;
  float* ob = const_cast<float*>(view_base(ov, P, ws, lane, row0));
  const float* xb = view_base(xv, P, ws, lane, row0);
  const int old = ov[2], xld = xv[2], xcs = xv[4];

  int pw = 1;
  while (pw < N && pw < RT_REGION_THREADS) pw <<= 1;
  int ksplit = RT_REGION_THREADS / pw;
  if (ksplit > 32) ksplit = 32;
  const int cn = threadIdx.x % pw, kp = threadIdx.x / pw;
  const bool active = kp < ksplit;

  const float* xr[RT_REGION_ROWS];
#pragma unroll
  for (int r = 0; r < RT_REGION_ROWS; ++r)
    xr[r] = xb + (r < rows ? r : rows - 1) * xld;  // clamp: stay in bounds

  for (int nc = 0; nc < N; nc += pw) {
    const int n = nc + cn;
    float acc[RT_REGION_ROWS];
#pragma unroll
    for (int r = 0; r < RT_REGION_ROWS; ++r) acc[r] = 0.f;
    const float* wc = W + (long long)k0 * ldw + n0 + n;
    // x goes through `red` in chunks of MM_XCHUNK columns, so the k loop
    // reads it with shared-memory loads (float4 ones where ksplit == 1)
    for (int kc = 0; kc < K; kc += MM_XCHUNK) {
      const int kn = K - kc < MM_XCHUNK ? K - kc : MM_XCHUNK;
      __syncthreads();  // the last readers of red are done
      for (int i = threadIdx.x; i < RT_REGION_ROWS * kn; i += blockDim.x) {
        const int r = i / kn, kk = i - r * kn;
        red[r * MM_XCHUNK + kk] = xr[r][(kc + kk) * xcs];
      }
      __syncthreads();
      if (!active || n >= N) continue;
      int kk = kp;
      if (ksplit == 1) {
        for (; kk + 3 < kn; kk += 4) {
          float w[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            w[u] = __ldg(wc + (long long)(kc + kk + u) * ldw);
#pragma unroll
          for (int r = 0; r < RT_REGION_ROWS; ++r) {
            const float4 x4 =
                *reinterpret_cast<const float4*>(red + r * MM_XCHUNK + kk);
            acc[r] = fmaf(x4.x, w[0], acc[r]);
            acc[r] = fmaf(x4.y, w[1], acc[r]);
            acc[r] = fmaf(x4.z, w[2], acc[r]);
            acc[r] = fmaf(x4.w, w[3], acc[r]);
          }
        }
      } else {
        // MM_UNROLL weight loads in flight before their FMAs: one at a
        // time leaves the loop waiting on L2 latency every k
        for (; kk + (MM_UNROLL - 1) * ksplit < kn; kk += MM_UNROLL * ksplit) {
          float w[MM_UNROLL];
#pragma unroll
          for (int u = 0; u < MM_UNROLL; ++u)
            w[u] = __ldg(wc + (long long)(kc + kk + u * ksplit) * ldw);
#pragma unroll
          for (int u = 0; u < MM_UNROLL; ++u)
#pragma unroll
            for (int r = 0; r < RT_REGION_ROWS; ++r)
              acc[r] = fmaf(red[r * MM_XCHUNK + kk + u * ksplit], w[u],
                            acc[r]);
        }
      }
      for (; kk < kn; kk += ksplit) {
        const float w = __ldg(wc + (long long)(kc + kk) * ldw);
#pragma unroll
        for (int r = 0; r < RT_REGION_ROWS; ++r)
          acc[r] = fmaf(red[r * MM_XCHUNK + kk], w, acc[r]);
      }
    }
    if (ksplit > 1) {
      __syncthreads();  // every thread is done reading x from red
      if (active) {
#pragma unroll
        for (int r = 0; r < RT_REGION_ROWS; ++r)
          red[(kp * RT_REGION_ROWS + r) * pw + cn] = acc[r];
      }
      __syncthreads();
      if (kp == 0) {
#pragma unroll
        for (int r = 0; r < RT_REGION_ROWS; ++r) {
          float s = 0.f;
          for (int q = 0; q < ksplit; ++q)
            s += red[(q * RT_REGION_ROWS + r) * pw + cn];
          acc[r] = s;
        }
      }
      __syncthreads();
    }
    if (kp == 0 && n < N) {
#pragma unroll
      for (int r = 0; r < RT_REGION_ROWS; ++r) {
        if (r >= rows) break;
        float h = acc[r];
        if (flags & 2) h = ob[r * old + n] + h;
        if (flags & 4) {
          if (bias) h += bias[n];
          if (flags & 1) {
            if (kSavePre) pre[r * N + n] = h;
            h = sinf(w0 * h);
          }
        }
        ob[r * old + n] = h;
      }
    }
  }
}
