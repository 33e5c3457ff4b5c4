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
// mm partial sums one region CTA keeps in shared memory
#define RT_RED_FLOATS (RT_REGION_THREADS * RT_REGION_ROWS)
#define RT_SMEM_BYTES 232448    // shared memory one CTA may use on Hopper
#define RT_SMEM_STATIC 1024     // region.cu's static shared arrays, at most
// attention tiles (kernels/flash_attention.py KERNEL_TILES)
#define RT_FA_BQ 64             // fp32 SIMT kernel: q rows of one CTA
#define RT_FA_BK 32             //   keys of one kv tile
#define RT_FA_TC_BQ 128         // bf16 tensor-core kernel: q rows of one CTA
#define RT_FA_TC_BK 128         //   keys of one kv tile at D <= 128
#define RT_FA_TC_BK_WIDE 64     //   keys of one kv tile at D = 256

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

// Apply a chain of n steps to h.  vals[i] is the baked constant of a
// scale/offset step; extra(e) returns the e-th binary step's operand at the
// caller's element.  fused_chain and the region megakernel both evaluate
// chains through this one function, as the reference shares eval_chain.
// sinf/cosf are the accurate (range-reduced) forms: never build with
// --use_fast_math.
template <class Extra>
__device__ __forceinline__ float eval_chain(float h, int n, const int* ops,
                                            const float* vals, Extra extra) {
  int e = 0;
  for (int i = 0; i < n; ++i) {
    switch (ops[i]) {
      case OP_SIN: h = sinf(h); break;
      case OP_COS: h = cosf(h); break;
      case OP_EXP: h = expf(h); break;
      case OP_TANH: h = tanhf(h); break;
      case OP_NEG: h = -h; break;
      case OP_ABS: h = fabsf(h); break;
      case OP_RELU: h = nan_max(h, 0.f); break;
      case OP_SIGMOID: h = 1.f / (1.f + expf(-h)); break;
      case OP_SILU: h = h * (1.f / (1.f + expf(-h))); break;
      case OP_SQUARE: h = h * h; break;
      case OP_SCALE: h = h * vals[i]; break;
      case OP_OFFSET: h = h + vals[i]; break;
      case OP_MUL: h = h * extra(e++); break;
      case OP_ADD: h = h + extra(e++); break;
      case OP_SUB: h = h - extra(e++); break;
      case OP_DIV: h = h / extra(e++); break;
      case OP_MAX: h = nan_max(h, extra(e++)); break;
      case OP_MIN: h = nan_min(h, extra(e++)); break;
      default: break;
    }
  }
  return h;
}
