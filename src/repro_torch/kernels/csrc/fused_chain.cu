// fused_chain: one elementwise chain over an [R, C] tensor.
//
// Replaces the TPU kernel repro/kernels/fused_chain.py::fused_chain
// (pallas_call at fused_chain.py:97).  The chain is a list of steps known
// only at run time (unary ops, baked scale/offset, binary ops against extra
// operands).  It reads x and each operand once and writes the output once,
// so on the H100 it is bound by device-memory bytes (3.35 TB/s); on the
// main path the tensors are one [8, 256] block, far below one wave, and
// what a launch costs is latency: the launch, the first reads of its
// parameters, memory round trips, and the chain's steps one after another
// (each an indexed read of its opcode and a jump).
//
// A CTA owns a tile of RT_CHAIN_ROWS x RT_CHAIN_COLS elements, a thread one
// element: the steps run one after another on each thread, so a thread that
// held several elements would lengthen the launch by their work.  All of a
// thread's operands are in flight before any arithmetic: x goes straight
// into a register and every extra is copied with cp.async, through its own
// strides (0 where it broadcasts), into the thread's own slot of shared
// memory, one slot block per extra; the thread waits once.  A chain with k
// extras so costs one memory round trip, not k + 1 (a load inside the
// switch of the step that uses it cannot be hoisted, since the ops are
// known only at run time).  A thread reads only the slots it filled, so
// the CTA needs no barrier.  The chain then runs through eval_chain, which
// the region kernels share, each element through the same operations in
// the same order.  The parameter block is a __grid_constant__, read in
// place.  Index math is 32-bit: rt_fused_chain refuses operands whose
// offsets do not fit.
#include <limits.h>

#include "abi.cuh"
#include "mbarrier.cuh"

constexpr int kThreads = RT_CHAIN_ROWS * RT_CHAIN_COLS;

struct Extra {
  const float* ptr;  // element [0, 0]
  int rs, cs;        // row and column stride in elements (0: broadcast)
};

struct ChainParams {
  const float* x;
  float* out;
  int R, C, tiles_c;  // tiles_c: column tiles of a tile row
  int n_ops, n_extra;
  int ops[RT_MAX_CHAIN];
  float vals[RT_MAX_CHAIN];
  Extra extra[RT_MAX_EXTRA];
};

__global__ void __launch_bounds__(kThreads)
    fused_chain_kernel(const __grid_constant__ ChainParams p) {
  extern __shared__ float s[];
  const int t = threadIdx.x;
  const int tr = blockIdx.x / p.tiles_c;
  const int r = tr * RT_CHAIN_ROWS + t / RT_CHAIN_COLS;
  const int c = (blockIdx.x - tr * p.tiles_c) * RT_CHAIN_COLS +
                t % RT_CHAIN_COLS;
  if (r >= p.R || c >= p.C) return;
  const float x = p.x[r * p.C + c];
  float* own = s + t;  // extra e's slot: own[e * kThreads]
  if (p.n_extra > 0) {
#pragma unroll
    for (int e = 0; e < RT_MAX_EXTRA; ++e) {
      if (e == p.n_extra) break;
      const Extra& o = p.extra[e];
      cp_async4(own + e * kThreads, o.ptr + r * o.rs + c * o.cs);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  p.out[r * p.C + c] = eval_chain(x, p.n_ops, p.ops, p.vals,
                                  [&](int e) { return own[e * kThreads]; });
}

// fused_chain's grid for an [R, C] tensor: one CTA a tile
static unsigned chain_tiles(int R, int C) {
  return (unsigned)((R + RT_CHAIN_ROWS - 1) / RT_CHAIN_ROWS) *
         (unsigned)((C + RT_CHAIN_COLS - 1) / RT_CHAIN_COLS);
}

// An empty kernel on fused_chain's grid and block: the floor under one
// launch of it (chip_smoke.py times it beside the chain).
__global__ void empty_kernel() {}

extern "C" int rt_launch_floor(int R, int C, void* stream) {
  if (R <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  empty_kernel<<<chain_tiles(R, C), kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// A chain as kernels/fused_chain.py::chain_program encodes it, once per
// distinct chain.
struct ChainProgram {
  int n_ops, n_extra;
  int ops[RT_MAX_CHAIN];
  float vals[RT_MAX_CHAIN];
};

// One call's tensors, as kernels/fused_chain.py::launch_args packs them.
struct ChainCall {
  const float* x;
  float* out;
  int R, C;
  struct {
    const float* ptr;
    long long rs, cs;
  } extra[RT_MAX_EXTRA];
};

extern "C" int rt_fused_chain(const ChainProgram* prog, const ChainCall* call,
                              void* stream) {
  const int R = call->R, C = call->C;
  if (prog->n_ops < 0 || prog->n_ops > RT_MAX_CHAIN || prog->n_extra < 0 ||
      prog->n_extra > RT_MAX_EXTRA || R <= 0 || C <= 0 ||
      (long long)R * C > INT_MAX)
    return (int)cudaErrorInvalidValue;
  ChainParams p;
  p.x = call->x;
  p.out = call->out;
  p.R = R;
  p.C = C;
  p.tiles_c = (C + RT_CHAIN_COLS - 1) / RT_CHAIN_COLS;
  p.n_ops = prog->n_ops;
  p.n_extra = prog->n_extra;
  for (int i = 0; i < prog->n_ops; ++i) {
    p.ops[i] = prog->ops[i];
    p.vals[i] = prog->vals[i];
  }
  for (int e = 0; e < prog->n_extra; ++e) {
    const long long rs = call->extra[e].rs, cs = call->extra[e].cs;
    if (rs < 0 || cs < 0 || (R - 1) * rs + (C - 1) * cs > INT_MAX)
      return (int)cudaErrorInvalidValue;
    p.extra[e] = {call->extra[e].ptr, (int)rs, (int)cs};
  }
  fused_chain_kernel<<<chain_tiles(R, C), kThreads,
                       sizeof(float) * kThreads * prog->n_extra,
                       (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int rt_abi(int* vals, int n) {
  const int abi[] = {RT_REGION_ROWS, RT_REGION_THREADS, RT_INSTR_INTS,
                     RT_MAX_PTRS,    RT_MAX_CHAIN,      RT_MAX_EXTRA,
                     OP_COUNT,       RT_RED_FLOATS,
                     RT_SMEM_BYTES - RT_SMEM_STATIC,    RT_MAX_LANES,
                     RT_BWD_IO_INTS, RT_FA_BQ,          RT_FA_BK,
                     RT_FA_TC_BQ,    RT_FA_TC_BK,       RT_FA_TC_BK_WIDE,
                     RT_WSTAGE_FLOATS, RT_WRING,        RT_MAX_CLUSTER,
                     RT_ROW_CLUSTER,   RT_ROWS_STAGES,
                     RT_ROW_GROUPS,    RT_COL_TILE,       RT_CHUNK_INTS,
                     RT_DESIGN_INTS,   RT_ROWS_CONSUMERS, RT_SM_SMEM_BYTES,
                     RT_SMEM_STATIC,   RT_CHAIN_ROWS,     RT_CHAIN_COLS,
                     RT_SSDB_MAX_NC};
  const int m = (int)(sizeof(abi) / sizeof(abi[0]));
  for (int i = 0; i < n && i < m; ++i) vals[i] = abi[i];
  return m;
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
