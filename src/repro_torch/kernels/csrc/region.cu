// region: a whole fused region of the gradient pipeline as ONE launch.
//
// Replaces the TPU megakernel repro/kernels/region.py::region_call
// (pallas_call at region.py:277), including its tile_groups column tiling
// (region.py::_eval_group).  Each RT_REGION_ROWS-row tile runs on a
// thread-block cluster of C CTAs (1 <= C <= RT_MAX_CLUSTER, chosen per shape
// by kernels/region.py::launch_cluster: wide clusters when few tiles leave
// most SMs idle, C = 1 when the tiles alone fill the card).  The CTAs walk
// the region's step program together, each on the columns it owns of every
// step's output (region_steps.cuh): chain steps (the same eval_chain as
// fused_chain), mm steps (x @ W [+ b] [-> sin(w0 .)]) and concat steps
// (copies into column ranges).  Intermediates never leave the cluster: a
// value lives in its owners' shared memory, [RT_REGION_ROWS, ceil(w / C)]
// per CTA, and an mm step gathers its whole x from the cluster through
// distributed shared memory.  A cluster barrier separates dependent steps.
// Weights are staged: each CTA streams the slice W[:, its columns] of every
// mm step through a ring of shared-memory stages filled by cp.async, issued
// one chunk ahead, so the next mm's weights arrive while the chain steps
// before it run.  A one-CTA launch (C = 1, the stacked shape: every tile
// would stage all of a lane's weights) has no ring and reads W from L2,
// in an instantiation whose register cap lets as many CTAs share an SM as
// their shared memory does.  Only when the workspace does not fit beside
// the staging buffers does it go to a per-CTA slice of a global buffer
// the wrapper allocates.
//
// The program is compiled once per region spec and C by kernels/region.py
// into an int32 instruction table and a float table that stay on the
// device, so a launch uploads nothing: it passes only the tensor pointers
// (by value, in the parameter block) and the row count.
//
// The same launch serves K weight lanes (repro/kernels/region.py::
// region_call_stacked, pallas_call at region.py:329): grid (tiles x C, K),
// and every pointer moves by lane x its per-lane stride.  Every output
// element is summed in an order fixed by its step's shape (region_steps.cuh),
// so lane k equals a K = 1 launch on lane k's operands bit for bit, whatever
// C either launch took.
//
// What bounds it on the H100: per 8-row tile an mm step does 2*8*K*N flops
// against K*N*4 weight bytes, so a launch is bound by bytes (weights) at
// 3.35 TB/s; at the main path's 8 rows per launch it is bound by latency:
// 47 dependent steps at order 2.  The cluster spreads each step over C SMs
// (an mm step [8,256]@[256,256] is 16 columns x 256 k per CTA at C = 16,
// out of shared memory), and the ring takes the weight loads off the
// critical path, which leaves a cluster barrier and the x gather per step.
#include "region_steps.cuh"

// grid (tiles x C, K): cluster blockIdx.x / C walks the step program on the
// RT_REGION_ROWS rows of its tile, blockIdx.y is the lane; R rows per lane.
// kCluster = false is the one-CTA launch (C = 1, many tiles): no ring, no
// distributed shared memory, and registers held to what kMinBlocks CTAs
// per SM allow, kMinBlocks being as many as the launch's shared memory
// lets an SM hold (region_entry).
template <bool kCluster, int kMinBlocks>
__global__ void __launch_bounds__(RT_REGION_THREADS, kMinBlocks)
    region_kernel(const int* __restrict__ gprog,
                  const float* __restrict__ gfc, int n_instr, LaneTable P,
                  long long R, int ws_floats, int xs_floats, int table_ints,
                  int fc_floats, float* gws) {
  extern __shared__ __align__(16) float smem[];
  Cta c;
  c.rank = kCluster ? (int)cg::this_cluster().block_rank() : 0;
  c.csize = kCluster ? (int)cg::this_cluster().num_blocks() : 1;
  c.lane = blockIdx.y;
  const long long tile = blockIdx.x / c.csize;
  c.row0 = tile * RT_REGION_ROWS;
  const long long left = R - c.row0;
  c.rows = left < RT_REGION_ROWS ? (int)left : RT_REGION_ROWS;
  c.ws_floats = ws_floats;
  Smem S;
  S.red = smem;
  S.xs = smem + RT_RED_FLOATS;
  S.ds = nullptr;
  WRing ring;
  ring.on = kCluster;
  ring.stage = S.xs + xs_floats;
  float* lws = ring.stage + (ring.on ? RT_WRING * RT_WSTAGE_FLOATS : 0);
  if (gws) {
    c.gws = gws + ((long long)c.lane * gridDim.x + tile * c.csize) * ws_floats;
    c.ws = c.gws + (long long)c.rank * ws_floats;
  } else {
    c.gws = nullptr;
    c.ws = lws;
  }
  const int* prog = gprog;
  const float* fc = gfc;
  stage_tables(prog, fc, table_ints, fc_floats,
               reinterpret_cast<int*>(lws + (gws ? 0 : ws_floats)),
               (long long)n_instr * RT_INSTR_INTS * sizeof(int));
  ring.prog = prog;
  ring.bwd = nullptr;
  ring.n_instr = n_instr;
  ring.start(c, P);
  cluster_barrier(c);  // every CTA of the cluster runs before any DSMEM read
  for (int s = 0; s < n_instr; ++s) {
    const int* I = prog + (long long)s * RT_INSTR_INTS;
    if (I[0] == 0)
      chain_step(I, prog, fc, P, c);
    else
      mm_step(I, fc, P, c, S, ring);
    cluster_barrier(c);
  }
  ring.drain();
}

static bool g_region_opted[4][64] = {{false}};

typedef void (*RegionEntry)(const int*, const float*, int, LaneTable,
                            long long, int, int, int, int, float*);

// The instantiation a launch of C CTAs per tile with `smem` bytes of
// dynamic shared memory runs (its index in g_region_opted in *slot): one
// for clusters, and for one-CTA launches the one whose register cap lets
// as many CTAs share an SM as its 228 KB of shared memory do (2-4).
static RegionEntry region_entry(int C, size_t smem, int* slot) {
  if (C > 1) {
    *slot = 0;
    return region_kernel<true, 1>;
  }
  // the runtime reserves 1 KB per CTA beside its static arrays
  const size_t per = smem + 1024 + RT_SMEM_STATIC;
  const int fit = (int)((size_t)233472 / per);
  *slot = fit >= 4 ? 3 : fit == 3 ? 2 : 1;
  return fit >= 4 ? region_kernel<false, 4>
                  : fit == 3 ? region_kernel<false, 3> : region_kernel<false, 2>;
}

// K lanes of R rows each, clusters of C CTAs.  strides[i]: elements between
// lane k and lane k + 1 of tensor i (a single-lane launch passes K = 1 and
// no strides).  A cluster the card cannot schedule is an error returned to
// the caller, never a quiet narrower launch.
extern "C" int rt_region(const int* prog, const float* fc, int n_instr,
                         int n_ptrs, const long long* ptrs,
                         const long long* strides, int K, long long R,
                         int ws_floats, int xs_floats, int table_ints,
                         int fc_floats, int C, float* gws, void* stream) {
  if (n_ptrs < 0 || n_ptrs > RT_MAX_PTRS || ws_floats < 0 || xs_floats < 0 ||
      (xs_floats & 3) || K < 0 || K > RT_MAX_LANES || C < 1 ||
      C > RT_MAX_CLUSTER || table_ints < 0 || fc_floats < 0)
    return (int)cudaErrorInvalidValue;
  LaneTable P;
  for (int i = 0; i < RT_MAX_PTRS; ++i) {
    P.p[i] = i < n_ptrs ? reinterpret_cast<const float*>(ptrs[i]) : nullptr;
    P.stride[i] = i < n_ptrs && strides ? strides[i] : 0;
  }
  if (R <= 0 || K == 0) return 0;
  const long long tiles = (R + RT_REGION_ROWS - 1) / RT_REGION_ROWS;
  const size_t smem = region_smem(xs_floats, 0, ws_floats, gws == nullptr, C,
                                  table_ints, fc_floats);
  int slot = 0;
  const RegionEntry kernel = region_entry(C, smem, &slot);
  cudaError_t e = region_attributes(kernel, g_region_opted[slot]);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, dim3((unsigned)(tiles * C), (unsigned)K), C,
                 smem, stream);
  e = cudaLaunchKernelEx(&cfg, kernel, prog, fc, n_instr, P, R, ws_floats,
                         xs_floats, table_ints, fc_floats, gws);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of C CTAs, each with `smem` bytes of dynamic shared
// memory, the card holds at once (cudaOccupancyMaxActiveClusters); a
// negative cudaError_t on failure.
extern "C" int rt_region_max_clusters(int C, long long smem) {
  if (C < 1 || C > RT_MAX_CLUSTER || smem < 0) return -(int)cudaErrorInvalidValue;
  int slot = 0;
  const RegionEntry kernel = region_entry(C, (size_t)smem, &slot);
  cudaError_t e = region_attributes(kernel, g_region_opted[slot]);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, dim3((unsigned)C), C, (size_t)smem, nullptr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}
