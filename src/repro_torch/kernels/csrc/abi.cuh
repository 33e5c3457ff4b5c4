// Constants and the elementwise chain evaluator shared by fused_chain.cu and
// region.cu.  The Python side mirrors every constant in kernels/common.py
// (ABI) and kernels/fused_chain.py (OPCODES); rt_abi() lets it check them.
#pragma once

#include <cuda_runtime.h>

#define RT_REGION_ROWS 8        // rows of one region CTA's tile
#define RT_REGION_THREADS 256   // threads of one region CTA
#define RT_INSTR_INTS 96        // ints per region instruction
#define RT_MAX_PTRS 96          // tensors one region launch may name
#define RT_MAX_LANES 65535      // weight lanes of one region launch
#define RT_MAX_CHAIN 32         // steps of one elementwise chain
#define RT_MAX_EXTRA 16         // streamed operands of one chain
#define RT_BWD_IO_INTS 4        // ints per io entry of a backward program
// fused_chain.cu: a CTA's tile of RT_CHAIN_ROWS x RT_CHAIN_COLS elements,
// a thread each
#define RT_CHAIN_ROWS 8
#define RT_CHAIN_COLS 16
// mm partial sums one region CTA keeps in shared memory
#define RT_RED_FLOATS (RT_REGION_THREADS * RT_REGION_ROWS)
#define RT_SMEM_BYTES 232448    // shared memory one CTA may use on Hopper
#define RT_SMEM_STATIC 1024     // region.cu's static shared arrays, at most
#define RT_SM_SMEM_BYTES 233472 // shared memory of one SM (228 KB)
#define RT_WSTAGE_FLOATS 8192   // floats of one stage of the region weight ring
#define RT_WRING 2              // stages of the region weight ring
#define RT_MAX_CLUSTER 16       // CTAs of one region cluster (non-portable > 8)
// the row-cluster launch (region.cu): tiles of 8, 16 or 32 rows per CTA,
// clusters of RT_ROW_CLUSTER row tiles (one where a lane has one tile)
// sharing each weight chunk through a ring of RT_ROWS_STAGES stages;
// RT_ROWS_CONSUMERS threads compute, an mm thread holding rows r,
// r + RT_ROW_GROUPS, ... of RT_COL_TILE adjacent columns
#define RT_ROW_CLUSTER 2
#define RT_ROWS_STAGES 2
#define RT_ROWS_CONSUMERS 256
#define RT_ROW_GROUPS 4
#define RT_COL_TILE 4
#define RT_CHUNK_INTS 5        // ints per chunk of the row-cluster ring's table
#define RT_DESIGN_INTS 7       // ints of a row-cluster launch's layout
// attention tiles (kernels/flash_attention.py KERNEL_TILES)
#define RT_FA_BQ 64             // fp32 SIMT kernel: q rows of one CTA
#define RT_FA_BK 32             //   keys of one kv tile
#define RT_FA_TC_BQ 128         // bf16 tensor-core kernel: q rows of one CTA
#define RT_FA_TC_BK 128         //   keys of one kv tile at D <= 128
#define RT_FA_TC_BK_WIDE 64     //   keys of one kv tile at D = 256
// ssd_scan.cu's backward: chunks of one launch (a [NC, 32] fp32 shared array)
#define RT_SSDB_MAX_NC 1792

// Chain opcodes, in the order of kernels/fused_chain.py OPCODES.
enum ChainOp : int {
  OP_SIN = 0, OP_COS, OP_EXP, OP_TANH, OP_NEG, OP_ABS, OP_RELU, OP_SIGMOID,
  OP_SILU, OP_SQUARE, OP_SCALE, OP_OFFSET, OP_MUL, OP_ADD, OP_SUB, OP_DIV,
  OP_MAX, OP_MIN, OP_COUNT
};

// max/min that propagate NaN like jnp.maximum / torch.maximum
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}

// Apply a chain of n steps to each of NV values h[v] (independent elements,
// in flight together).  vals[i] is the baked constant of a scale/offset
// step; extra(e, v) returns the e-th binary step's operand at value v's
// element.  Each value goes through the same operations in the same order
// as it would alone.  fused_chain and the region megakernel both evaluate
// chains through this one function, as the reference shares eval_chain.
// sinf/cosf are the accurate (range-reduced) forms: never build with
// --use_fast_math.
template <int NV, class Extra>
__device__ __forceinline__ void eval_chain_n(float (&h)[NV], int n,
                                             const int* ops,
                                             const float* vals, Extra extra) {
// the step's operation on every value, as one basic block
#define RT_EACH(expr)                              \
  _Pragma("unroll") for (int v = 0; v < NV; ++v) { \
    float& x = h[v];                               \
    expr;                                          \
  }
  int e = 0;
  for (int i = 0; i < n; ++i) {
    switch (ops[i]) {
      case OP_SIN: RT_EACH(x = sinf(x)); break;
      case OP_COS: RT_EACH(x = cosf(x)); break;
      case OP_EXP: RT_EACH(x = expf(x)); break;
      case OP_TANH: RT_EACH(x = tanhf(x)); break;
      case OP_NEG: RT_EACH(x = -x); break;
      case OP_ABS: RT_EACH(x = fabsf(x)); break;
      case OP_RELU: RT_EACH(x = nan_max(x, 0.f)); break;
      case OP_SIGMOID: RT_EACH(x = 1.f / (1.f + expf(-x))); break;
      case OP_SILU: RT_EACH(x = x * (1.f / (1.f + expf(-x)))); break;
      case OP_SQUARE: RT_EACH(x = x * x); break;
      case OP_SCALE: RT_EACH(x = x * vals[i]); break;
      case OP_OFFSET: RT_EACH(x = x + vals[i]); break;
      case OP_MUL: RT_EACH(x = x * extra(e, v)); ++e; break;
      case OP_ADD: RT_EACH(x = x + extra(e, v)); ++e; break;
      case OP_SUB: RT_EACH(x = x - extra(e, v)); ++e; break;
      case OP_DIV: RT_EACH(x = x / extra(e, v)); ++e; break;
      case OP_MAX: RT_EACH(x = nan_max(x, extra(e, v))); ++e; break;
      case OP_MIN: RT_EACH(x = nan_min(x, extra(e, v))); ++e; break;
      default: break;
    }
  }
#undef RT_EACH
}

// One value: extra(e) returns the e-th binary step's operand.
template <class Extra>
__device__ __forceinline__ float eval_chain(float h, int n, const int* ops,
                                            const float* vals, Extra extra) {
  float v[1] = {h};
  eval_chain_n<1>(v, n, ops, vals, [&](int e, int) { return extra(e); });
  return v[0];
}
