// region: a whole fused region of the gradient pipeline as ONE launch.
//
// Replaces the TPU megakernel repro/kernels/region.py::region_call
// (pallas_call at region.py:277), including its tile_groups column tiling
// (region.py::_eval_group).  One CTA owns RT_REGION_ROWS rows and walks the
// region's step program: chain steps (the same eval_chain as fused_chain),
// mm steps (x @ W [+ b] [-> sin(w0 .)]), concat steps (copies into column
// ranges).  Intermediates never leave the CTA: they live in liveness-packed
// slots of shared memory, or, when the slots exceed what a CTA may hold,
// in a per-CTA slice of a global workspace the wrapper allocates (L2-warm).
// Weights are read from device memory through the 50 MB L2, never staged
// whole in shared memory (one 256 x 256 fp32 weight is larger than a CTA's
// 227 KB).
//
// The program is compiled once per region spec by kernels/region.py into an
// int32 instruction table and a float table that stay on the device, so a
// launch uploads nothing: it passes only the tensor pointers (by value, in
// the parameter block) and the row count.
//
// The same launch serves K weight lanes (repro/kernels/region.py::
// region_call_stacked, pallas_call at region.py:329): grid (row tiles, K),
// and every pointer moves by lane x its per-lane stride.  Each CTA runs the
// single-lane arithmetic, so lane k equals a K = 1 launch on lane k's
// operands bit for bit.  A lane's tiles have consecutive block indices, so
// they run together while that lane's weights are hot in L2.
//
// What bounds it on the H100: per 8-row block an mm step does 2*8*K*N flops
// against K*N*4 weight bytes, so the region is bound by bytes (weights) at
// 3.35 TB/s, and at the main path's 8 rows per launch by the launch and by
// running on one SM.  A thread owns one output column of an mm step for all
// RT_REGION_ROWS rows, so each weight element is read once per CTA and feeds
// RT_REGION_ROWS FMAs; narrow outputs (N < 256) split K across threads and
// reduce the partial sums through shared memory in a fixed order.  x is
// staged through shared memory so the k loop reads it with shared-memory
// loads (a view may point at global memory, so the compiler cannot tell on
// its own).  Measured on the H100, an mm step [8,256]@[256,256] still takes
// ~20 us here, several times its FMA time on one SM (see PERF.md).
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
// through shared memory.
__device__ __forceinline__ void mm_step(const int* I, const float* fc,
                                        const LaneTable& P, float* ws,
                                        float* red, long long lane,
                                        long long row0, int rows) {
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
          if (flags & 1) h = sinf(w0 * h);
        }
        ob[r * old + n] = h;
      }
    }
  }
}

// grid (row tiles, K): one CTA walks the region's step program on the
// RT_REGION_ROWS rows of its tile, blockIdx.y is the lane; R rows per lane.
__global__ void __launch_bounds__(RT_REGION_THREADS)
    region_kernel(const int* __restrict__ prog, const float* __restrict__ fc,
                  int n_instr, LaneTable P, long long R, int ws_floats,
                  float* gws) {
  extern __shared__ float smem[];
  float* red = smem;  // RT_RED_FLOATS partial sums of the mm steps
  const long long lane = blockIdx.y;
  float* ws = gws ? gws + (lane * gridDim.x + blockIdx.x) * ws_floats
                  : smem + RT_RED_FLOATS;
  const long long row0 = (long long)blockIdx.x * RT_REGION_ROWS;
  const long long left = R - row0;
  const int rows = left < RT_REGION_ROWS ? (int)left : RT_REGION_ROWS;
  for (int s = 0; s < n_instr; ++s) {
    const int* I = prog + (long long)s * RT_INSTR_INTS;
    if (I[0] == 0)
      chain_step(I, prog, fc, P, ws, lane, row0, rows);
    else
      mm_step(I, fc, P, ws, red, lane, row0, rows);
    __syncthreads();
  }
}

// K lanes of R rows each.  strides[i]: elements between lane k and lane
// k + 1 of tensor i (a single-lane launch passes K = 1 and no strides).
extern "C" int rt_region(const int* prog, const float* fc, int n_instr,
                         int n_ptrs, const long long* ptrs,
                         const long long* strides, int K, long long R,
                         int ws_floats, float* gws, void* stream) {
  if (n_ptrs < 0 || n_ptrs > RT_MAX_PTRS || ws_floats < 0 || K < 0 ||
      K > RT_MAX_LANES)
    return (int)cudaErrorInvalidValue;
  LaneTable P;
  for (int i = 0; i < RT_MAX_PTRS; ++i) {
    P.p[i] = i < n_ptrs ? reinterpret_cast<const float*>(ptrs[i]) : nullptr;
    P.stride[i] = i < n_ptrs && strides ? strides[i] : 0;
  }
  if (R <= 0 || K == 0) return 0;
  const long long grid = (R + RT_REGION_ROWS - 1) / RT_REGION_ROWS;
  const size_t smem =
      sizeof(float) * ((size_t)RT_RED_FLOATS + (gws ? 0 : (size_t)ws_floats));
  if (smem > 48 * 1024) {
    // above 48 KB a kernel must opt in, once per device
    static bool opted[64] = {false};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64 || !opted[dev]) {
      cudaFuncAttributes attr;
      e = cudaFuncGetAttributes(&attr, region_kernel);
      if (e != cudaSuccess) return (int)e;
      e = cudaFuncSetAttribute(
          region_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          RT_SMEM_BYTES - (int)attr.sharedSizeBytes);
      if (e != cudaSuccess) return (int)e;
      if (dev < 64) opted[dev] = true;
    }
  }
  region_kernel<<<dim3((unsigned)grid, (unsigned)K), RT_REGION_THREADS, smem,
                  (cudaStream_t)stream>>>(prog, fc, n_instr, P, R, ws_floats,
                                          gws);
  return (int)cudaGetLastError();
}
