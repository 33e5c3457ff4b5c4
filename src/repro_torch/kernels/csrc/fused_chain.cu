// fused_chain: one elementwise chain over an [R, C] tensor.
//
// Replaces the TPU kernel repro/kernels/fused_chain.py::fused_chain
// (pallas_call at fused_chain.py:97).  The chain is a static list of steps
// (unary ops, baked scale/offset, binary ops against streamed operands).
// It reads x and each operand once and writes the output once, so on the
// H100 it is bound by device-memory bytes (3.35 TB/s); on the main path the
// tensors are one 8-row block and the launch itself dominates.  One thread
// per element, grid-stride; the opcodes and operand pointers travel in the
// kernel's parameter block, so a launch needs no upload.  Operands may be
// broadcast views: each carries its own row and column stride (0 = broadcast).
#include "abi.cuh"

struct ChainParams {
  int n_ops;
  int ops[RT_MAX_CHAIN];
  float vals[RT_MAX_CHAIN];
  int n_extra;
  const float* extra[RT_MAX_EXTRA];
  long long rs[RT_MAX_EXTRA];
  long long cs[RT_MAX_EXTRA];
};

__global__ void fused_chain_kernel(const float* __restrict__ x,
                                   float* __restrict__ out, long long R, int C,
                                   ChainParams p) {
  const long long n = R * C;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / C;
    const long long c = i - r * C;
    out[i] = eval_chain(x[i], p.n_ops, p.ops, p.vals, [&](int e) {
      return p.extra[e][r * p.rs[e] + c * p.cs[e]];
    });
  }
}

extern "C" int rt_fused_chain(const float* x, float* out, long long R, int C,
                              int n_ops, const int* ops, const float* vals,
                              int n_extra, const void* const* extra,
                              const long long* rs, const long long* cs,
                              void* stream) {
  if (n_ops < 0 || n_ops > RT_MAX_CHAIN || n_extra < 0 ||
      n_extra > RT_MAX_EXTRA)
    return (int)cudaErrorInvalidValue;
  ChainParams p;
  p.n_ops = n_ops;
  for (int i = 0; i < n_ops; ++i) {
    p.ops[i] = ops[i];
    p.vals[i] = vals[i];
  }
  p.n_extra = n_extra;
  for (int e = 0; e < n_extra; ++e) {
    p.extra[e] = static_cast<const float*>(extra[e]);
    p.rs[e] = rs[e];
    p.cs[e] = cs[e];
  }
  const long long n = R * C;
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  fused_chain_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      x, out, R, C, p);
  return (int)cudaGetLastError();
}

extern "C" int rt_abi(int* vals, int n) {
  const int abi[] = {RT_REGION_ROWS, RT_REGION_THREADS, RT_INSTR_INTS,
                     RT_MAX_PTRS,    RT_MAX_CHAIN,      RT_MAX_EXTRA,
                     OP_COUNT,       RT_RED_FLOATS,
                     RT_SMEM_BYTES - RT_SMEM_STATIC,    RT_MAX_LANES,
                     RT_BWD_IO_INTS, RT_FA_BQ,          RT_FA_BK,
                     RT_FA_TC_BQ,    RT_FA_TC_BK,       RT_FA_TC_BK_WIDE,
                     RT_WSTAGE_FLOATS, RT_WRING,        RT_MAX_CLUSTER};
  const int m = (int)(sizeof(abi) / sizeof(abi[0]));
  for (int i = 0; i < n && i < m; ++i) vals[i] = abi[i];
  return m;
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
