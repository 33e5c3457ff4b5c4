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
// The step functions (views, chain_step, mm_step) are in region_steps.cuh,
// which region_bwd.cu shares for its replay of the forward.
#include "region_steps.cuh"

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
  if (smem > 48 * 1024 - RT_SMEM_STATIC) {
    // above 48 KB with the static arrays a kernel must opt in, once per
    // device
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
