// region_bwd: the backward of one fused region as ONE launch, plus a
// reduction launch when the region spans more than one row tile.
//
// Replaces the TPU kernel repro/kernels/region.py::_region_bwd_kernel (kernel
// body at region.py:347, pallas_call at :435 in _region_bwd_call :393), the
// backward that region_grad_fn (:451) gives the fit path's region call.  The
// TPU kernel replays the step program under jax.vjp per row tile and carries
// the parameter cotangents across its sequential grid in VMEM.  Here CTAs run
// in parallel and in no order, so nothing carries over: each CTA owns
// RT_REGION_ROWS rows (as rt_region does) and
//   1. replays the forward step program (region_steps.cuh, the same
//      chain_step / mm_step as the forward kernel), keeping EVERY value in
//      its own workspace slot (no liveness packing: the reverse walk reads
//      them all) and, for each sin epilogue, the argument h of sin(w0 h);
//   2. walks a backward table in reverse step order, adding into
//      zero-initialised cotangent slots, one per value (stream inputs and
//      bcast rows included);
//   3. writes its rows' stream cotangents, and its partial sums of the
//      bcast-row and resident cotangents to its own slice of a partial
//      buffer.  A second launch (rt_region_bwd_reduce) adds the partials in
//      CTA order; with one CTA (the fit path's 8-row block) the partial is
//      the result and the wrapper skips it.  No atomics anywhere, so the
//      result is the same bit for bit from run to run.
// Rules per step (kernels/region.py::lower_bwd writes the tables):
//   mm:    dpre = dout * cos(w0 pre) * w0 when the epilogue applies sin;
//          db += sum_rows dpre; dW[k0:, n0:] += x^T dpre; dx += dpre W^T.
//          dpre is written over dout in place, so an accumulating tile of a
//          column-tiled reducer (flag 2) hands it on unchanged to the
//          tiles before it.
//   chain: one warp per row recomputes the chain's intermediates per
//          element, then pulls back through each opcode (chain_op_bwd,
//          with JAX's rules at the edges: max/min, relu included, split
//          ties evenly; abs passes g where x >= 0, so 1 at 0, as
//          jnp.abs's rule does).  Operands read with
//          column stride 0 (one column broadcast) sum their cotangent over
//          the columns through a warp reduction; bcast rows (row stride 0)
//          collect a per-row cotangent that step 3 sums over rows.
//   concat: a chain of no ops into a column range, so the cotangent splits
//          by column range.
//
// What bounds it on the H100: the true bound of one 8-row launch is ~1 us
// (each weight read once and its cotangent written once at 3.35 TB/s; the
// flops at 67 TFLOP/s take less).  The launch is far from it because one
// CTA of 8 warps runs the whole region on one SM, so it waits on L2
// latency: an mm step reads W again for dx and read-modify-writes the CTA's
// K x N partial of dW, and the values and cotangents (~0.7 MB per CTA at
// full-width order 2) live in an L2-warm global workspace.  The design
// keeps loads in flight instead: dW holds a column's 8 dpre values in
// registers and keeps BW_RMW read-modify-writes outstanding; dx reads a
// W row coalesced with the next row's loads issued early, x and dpre are
// staged in shared memory, and the 8 rows' dx sums are written by 8 lanes
// at once.  Tensor cores, weight tiles staged in shared memory and more
// rows per CTA are the next steps (ROADMAP Queue 2, PERF.md).
#include "region_steps.cuh"

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // lane 0 holds the sum, added in a fixed order
}

// Pull g back through one chain op: h is the op's input, y its output, v its
// baked constant, x its binary operand.  Returns the cotangent of h and, for
// a binary op, writes the operand's to *dx.  The formulas are the ones
// torch.autograd applies to kernels/fused_chain.py::eval_chain, whose relu
// and abs are written so that their edges follow JAX's.
__device__ __forceinline__ float chain_op_bwd(int op, float h, float y,
                                              float v, float x, float g,
                                              float* dx) {
  switch (op) {
    case OP_SIN: return g * cosf(h);
    case OP_COS: return -(g * sinf(h));
    case OP_EXP: return g * y;
    case OP_TANH: return g * (1.f - y * y);
    case OP_NEG: return -g;
    case OP_ABS: return h >= 0.f ? g : -g;
    case OP_RELU: return h < 0.f ? 0.f : (h == 0.f ? 0.5f * g : g);
    case OP_SIGMOID: return g * (1.f - y) * y;
    case OP_SILU: {
      const float s = 1.f / (1.f + expf(-h));
      return g * s + (g * h) * ((1.f - s) * s);
    }
    case OP_SQUARE: return g * (2.f * h);
    case OP_SCALE: return g * v;
    case OP_OFFSET: return g;
    case OP_MUL: *dx = g * h; return g * x;
    case OP_ADD: *dx = g; return g;
    case OP_SUB: *dx = -g; return g;
    case OP_DIV: *dx = -g * ((h / x) / x); return g / x;
    case OP_MAX:
      *dx = h > x ? 0.f : (h == x ? 0.5f * g : g);
      return h < x ? 0.f : (h == x ? 0.5f * g : g);
    case OP_MIN:
      *dx = h < x ? 0.f : (h == x ? 0.5f * g : g);
      return h > x ? 0.f : (h == x ? 0.5f * g : g);
    default: return g;
  }
}

// Backward tables (RT_INSTR_INTS ints per step, beside the forward table).
// A cotangent view is 5 ints like a value view (always the workspace):
// space, slot offset, row stride, column offset, column stride.
//   chain: [0..4] out, [5..9] x, [10+5e..] extra e
//   mm:    [0..4] out, [5..9] x, [10] pre slot or -1, [11] W's offset in
//          the partial buffer, [12] the bias's or -1
__device__ void chain_bwd(const int* I, const int* B, const int* prog,
                          const float* fc, const LaneTable& P, float* ws,
                          long long row0, int rows) {
  const int C = I[1], n_ops = I[2], n_extra = I[5];
  const int* ops = prog + I[3];
  const float* vals = fc + I[4];
  const int r = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= rows) return;  // whole warps: one warp per row
  const int* xv = I + 11;
  const float* xb = view_base(xv, P, ws, 0, row0) + r * xv[2];
  const int xcs = xv[4];
  const float* eb[RT_MAX_EXTRA];
  float* geb[RT_MAX_EXTRA];
  int ecs[RT_MAX_EXTRA];
  for (int e = 0; e < n_extra; ++e) {
    const int* v = I + 16 + 5 * e;
    const int* cv = B + 10 + 5 * e;
    eb[e] = view_base(v, P, ws, 0, row0) + r * v[2];
    ecs[e] = v[4];
    geb[e] = ws + cv[1] + cv[3] + r * cv[2];
  }
  const float* go = ws + B[1] + B[3] + r * B[2];
  float* gx = ws + B[6] + B[8] + r * B[7];
  float sx = 0.f, se[RT_MAX_EXTRA];
  for (int e = 0; e < n_extra; ++e) se[e] = 0.f;
  for (int c = lane; c < C; c += 32) {
    float hs[RT_MAX_CHAIN + 1], ev[RT_MAX_EXTRA], de[RT_MAX_EXTRA];
    for (int e = 0; e < n_extra; ++e) ev[e] = eb[e][c * ecs[e]];
    float h = xb[c * xcs];
    int e = 0;
    for (int i = 0; i < n_ops; ++i) {
      hs[i] = h;
      const bool bin = ops[i] >= OP_MUL;
      const float xe = bin ? ev[e] : 0.f;
      h = eval_chain(h, 1, ops + i, vals + i, [&](int) { return xe; });
      if (bin) ++e;
    }
    hs[n_ops] = h;
    float g = go[c];
    for (int i = n_ops - 1; i >= 0; --i) {
      const bool bin = ops[i] >= OP_MUL;
      if (bin) --e;
      float d = 0.f;
      g = chain_op_bwd(ops[i], hs[i], hs[i + 1], vals[i], bin ? ev[e] : 0.f,
                       g, &d);
      if (bin) de[e] = d;
    }
    if (xcs) gx[c] += g; else sx += g;
    for (int k = 0; k < n_extra; ++k) {
      if (ecs[k]) geb[k][c] += de[k]; else se[k] += de[k];
    }
  }
  if (!xcs) {
    sx = warp_sum(sx);
    if (lane == 0) gx[0] += sx;
  }
  for (int e = 0; e < n_extra; ++e) {
    if (ecs[e]) continue;
    const float s = warp_sum(se[e]);
    if (lane == 0) geb[e][0] += s;
  }
}

// x columns (and dpre columns) one pass of mm_bwd stages, 8 rows each
#define BW_CHUNK (RT_RED_FLOATS / RT_REGION_ROWS)
#define BW_RMW 8  // dW read-modify-writes a thread keeps in flight

__device__ void mm_bwd(const int* I, const int* B, const float* fc,
                       const LaneTable& P, float* ws, float* xs, float* ds,
                       float* part, long long row0, int rows) {
  const int N = I[1], K = I[2];
  const float* W = tensor(P, I[3], 0);
  const int ldw = I[4], k0 = I[5], n0 = I[6], flags = I[8];
  const float w0 = fc[I[9]];
  const int* xv = I + 15;
  const float* xb = view_base(xv, P, ws, 0, row0);
  const int xld = xv[2];
  float* g = ws + B[1] + B[3];  // dout, then dpre in place
  const int gld = B[2];
  float* gx = ws + B[6] + B[8];
  const int gxld = B[7];
  const int t = threadIdx.x;
  if ((flags & 4) && (flags & 1)) {
    const float* pre = ws + B[10];
    for (int i = t; i < rows * N; i += blockDim.x) {
      const int r = i / N, n = i - r * N;
      float* gp = g + r * gld + n;
      *gp = (*gp * cosf(w0 * pre[r * N + n])) * w0;
    }
    __syncthreads();
  }
  if ((flags & 4) && B[12] >= 0) {
    float* db = part + B[12] + n0;
    for (int n = t; n < N; n += blockDim.x) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += g[r * gld + n];
      db[n] += s;
    }
  }
  // dW[k, n] += sum_r x[r, k] dpre[r, n]: a thread owns a column n (pw
  // threads across columns, ksplit more across k), holds its 8 dpre values
  // in registers and walks k with BW_RMW read-modify-writes in flight; x
  // goes through shared memory BW_CHUNK columns at a time (rows past the
  // tile are zeros, so every sum runs over 8 rows in order).
  int pw = 1;
  while (pw < N && pw < RT_REGION_THREADS) pw <<= 1;
  const int ksplit = RT_REGION_THREADS / pw;
  const int cn = t % pw, kp = t / pw;
  float* dW = part + B[11] + (long long)k0 * ldw + n0;
  for (int kc = 0; kc < K; kc += BW_CHUNK) {
    const int kn = K - kc < BW_CHUNK ? K - kc : BW_CHUNK;
    __syncthreads();  // the last readers of xs are done
    for (int i = t; i < RT_REGION_ROWS * BW_CHUNK; i += blockDim.x) {
      const int r = i / BW_CHUNK, kk = i - r * BW_CHUNK;
      xs[i] = r < rows && kk < kn ? xb[r * xld + kc + kk] : 0.f;
    }
    __syncthreads();
    for (int n = cn; n < N; n += pw) {
      float gr[RT_REGION_ROWS];
#pragma unroll
      for (int r = 0; r < RT_REGION_ROWS; ++r)
        gr[r] = r < rows ? g[r * gld + n] : 0.f;
      float* col = dW + (long long)kc * ldw + n;
      int kk = kp;
      for (; kk + (BW_RMW - 1) * ksplit < kn; kk += BW_RMW * ksplit) {
        float old[BW_RMW], s[BW_RMW];
#pragma unroll
        for (int u = 0; u < BW_RMW; ++u)
          old[u] = col[(long long)(kk + u * ksplit) * ldw];
#pragma unroll
        for (int u = 0; u < BW_RMW; ++u) s[u] = 0.f;
        if (ksplit == 1) {  // consecutive k: x read as float4
#pragma unroll
          for (int r = 0; r < RT_REGION_ROWS; ++r)
#pragma unroll
            for (int q = 0; q < BW_RMW; q += 4) {
              const float4 x4 = *reinterpret_cast<const float4*>(
                  xs + r * BW_CHUNK + kk + q);
              s[q] = fmaf(x4.x, gr[r], s[q]);
              s[q + 1] = fmaf(x4.y, gr[r], s[q + 1]);
              s[q + 2] = fmaf(x4.z, gr[r], s[q + 2]);
              s[q + 3] = fmaf(x4.w, gr[r], s[q + 3]);
            }
        } else {
#pragma unroll
          for (int u = 0; u < BW_RMW; ++u)
#pragma unroll
            for (int r = 0; r < RT_REGION_ROWS; ++r)
              s[u] = fmaf(xs[r * BW_CHUNK + kk + u * ksplit], gr[r], s[u]);
        }
#pragma unroll
        for (int u = 0; u < BW_RMW; ++u)
          col[(long long)(kk + u * ksplit) * ldw] = old[u] + s[u];
      }
      for (; kk < kn; kk += ksplit) {
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < RT_REGION_ROWS; ++r)
          s = fmaf(xs[r * BW_CHUNK + kk], gr[r], s);
        col[(long long)kk * ldw] += s;
      }
    }
  }
  // dx[r, k] += sum_n dpre[r, n] W[k, n]: a warp owns a row k of W, read
  // coalesced with all BW_CHUNK / 32 loads in flight (the next row's are
  // issued before this row's FMAs); dpre goes through shared memory (zeros
  // past the tile); the lanes' sums meet in a butterfly, which leaves every
  // lane the same sums
  const int warp = t / 32, lane = t % 32, n_warps = blockDim.x / 32;
  for (int nc = 0; nc < N; nc += BW_CHUNK) {
    const int nn = N - nc < BW_CHUNK ? N - nc : BW_CHUNK;
    __syncthreads();  // the last readers of ds are done
    for (int i = t; i < RT_REGION_ROWS * BW_CHUNK; i += blockDim.x) {
      const int r = i / BW_CHUNK, j = i - r * BW_CHUNK;
      ds[i] = r < rows && j < nn ? g[r * gld + nc + j] : 0.f;
    }
    __syncthreads();
    float wv[BW_CHUNK / 32];
    auto load_row = [&](int k) {
      const float* wr = W + (long long)(k0 + k) * ldw + n0 + nc;
#pragma unroll
      for (int p = 0; p < BW_CHUNK / 32; ++p) {
        const int n = p * 32 + lane;
        wv[p] = k < K && n < nn ? __ldg(wr + n) : 0.f;
      }
    };
    load_row(warp);
    // lane j keeps the sums of the warp's j-th row of W and writes them
    // when the warp has done 32 rows (or all of its rows): the read-
    // modify-writes of dx leave the loop over k
    float keep[RT_REGION_ROWS];
    int keep_k = -1, j = 0;
    for (int k = warp; k < K; k += n_warps, ++j) {
      float cur[BW_CHUNK / 32];
#pragma unroll
      for (int p = 0; p < BW_CHUNK / 32; ++p) cur[p] = wv[p];
      load_row(k + n_warps);
      float acc[RT_REGION_ROWS];
#pragma unroll
      for (int r = 0; r < RT_REGION_ROWS; ++r) acc[r] = 0.f;
#pragma unroll
      for (int p = 0; p < BW_CHUNK / 32; ++p)
#pragma unroll
        for (int r = 0; r < RT_REGION_ROWS; ++r)
          acc[r] = fmaf(ds[r * BW_CHUNK + p * 32 + lane], cur[p], acc[r]);
      const bool mine = lane == (j & 31);
#pragma unroll
      for (int r = 0; r < RT_REGION_ROWS; ++r) {
        float v = acc[r];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (mine) keep[r] = v;
      }
      if (mine) keep_k = k;
      if ((j & 31) == 31 || k + n_warps >= K) {
        if (keep_k >= 0) {
          float old[RT_REGION_ROWS];
#pragma unroll
          for (int r = 0; r < RT_REGION_ROWS; ++r)
            old[r] = r < rows ? gx[r * gxld + keep_k] : 0.f;
#pragma unroll
          for (int r = 0; r < RT_REGION_ROWS; ++r)
            if (r < rows) gx[r * gxld + keep_k] = old[r] + keep[r];
        }
        keep_k = -1;
      }
    }
  }
}

// grid (row tiles): CTA b owns rows [8 b, 8 b + 8) and the partial slice
// gpart[b * part_floats, (b + 1) * part_floats).  io entries
// (RT_BWD_IO_INTS ints): [kind, a, C, slot] with kind 0 = seed the slot
// from output cotangent tensor a, 1 = write the slot to stream cotangent
// tensor a, 2 = sum the slot's rows into the partial at offset a.
__global__ void __launch_bounds__(RT_REGION_THREADS)
    region_bwd_kernel(const int* __restrict__ prog,
                      const float* __restrict__ fc, int n_instr, int io_off,
                      int n_io, LaneTable P, long long R, int ws_floats,
                      int cot_off, float* gws, long long part_floats,
                      float* gpart) {
  extern __shared__ float smem[];
  float* red = smem;                  // x staging (forward and dW)
  float* ds = smem + RT_RED_FLOATS;   // dpre staging (dx)
  float* ws = gws ? gws + (long long)blockIdx.x * ws_floats
                  : smem + 2 * RT_RED_FLOATS;
  float* part = gpart + (long long)blockIdx.x * part_floats;
  const long long row0 = (long long)blockIdx.x * RT_REGION_ROWS;
  const long long left = R - row0;
  const int rows = left < RT_REGION_ROWS ? (int)left : RT_REGION_ROWS;
  const int* bwd = prog + (long long)n_instr * RT_INSTR_INTS;
  const int* io = prog + io_off;
  const int t = threadIdx.x;
  for (long long i = t; i < part_floats; i += blockDim.x) part[i] = 0.f;
  // the cotangent slots start at cot_off; value slots are written first
  for (int i = cot_off + t; i < ws_floats; i += blockDim.x) ws[i] = 0.f;
  __syncthreads();
  for (int j = 0; j < n_io; ++j) {
    const int* e = io + RT_BWD_IO_INTS * j;
    if (e[0] != 0) continue;
    const float* src = tensor(P, e[1], 0) + row0 * e[2];
    float* dst = ws + e[3];
    for (int i = t; i < rows * e[2]; i += blockDim.x) dst[i] += src[i];
  }
  __syncthreads();
  for (int s = 0; s < n_instr; ++s) {
    const int* I = prog + (long long)s * RT_INSTR_INTS;
    const int* B = bwd + (long long)s * RT_INSTR_INTS;
    if (I[0] == 0)
      chain_step(I, prog, fc, P, ws, 0, row0, rows);
    else
      mm_step<true>(I, fc, P, ws, red, 0, row0, rows,
                    B[10] >= 0 ? ws + B[10] : nullptr);
    __syncthreads();
  }
  for (int s = n_instr - 1; s >= 0; --s) {
    const int* I = prog + (long long)s * RT_INSTR_INTS;
    const int* B = bwd + (long long)s * RT_INSTR_INTS;
    if (I[0] == 0)
      chain_bwd(I, B, prog, fc, P, ws, row0, rows);
    else
      mm_bwd(I, B, fc, P, ws, red, ds, part, row0, rows);
    __syncthreads();
  }
  for (int j = 0; j < n_io; ++j) {
    const int* e = io + RT_BWD_IO_INTS * j;
    const int C = e[2];
    const float* src = ws + e[3];
    if (e[0] == 1) {
      float* dst = const_cast<float*>(tensor(P, e[1], 0)) + row0 * C;
      for (int i = t; i < rows * C; i += blockDim.x) dst[i] = src[i];
    } else if (e[0] == 2) {
      for (int c = t; c < C; c += blockDim.x) {
        float s = 0.f;
        for (int r = 0; r < rows; ++r) s += src[r * C + c];
        part[e[1] + c] = s;
      }
    }
  }
}

// out[i] = sum over CTAs b, in order, of part[b * P + i]
__global__ void region_bwd_reduce_kernel(const float* __restrict__ part,
                                         long long G, long long P,
                                         float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  float s = 0.f;
  for (long long b = 0; b < G; ++b) s += part[b * P + i];
  out[i] = s;
}

extern "C" int rt_region_bwd(const int* prog, const float* fc, int n_instr,
                             int io_off, int n_io, int n_ptrs,
                             const long long* ptrs, long long R, int ws_floats,
                             int cot_off, float* gws, long long part_floats,
                             float* gpart, void* stream) {
  if (n_ptrs < 0 || n_ptrs > RT_MAX_PTRS || ws_floats < 0 || n_io < 0 ||
      part_floats < 0 || cot_off < 0 || cot_off > ws_floats)
    return (int)cudaErrorInvalidValue;
  LaneTable P;
  for (int i = 0; i < RT_MAX_PTRS; ++i) {
    P.p[i] = i < n_ptrs ? reinterpret_cast<const float*>(ptrs[i]) : nullptr;
    P.stride[i] = 0;
  }
  if (R <= 0) return 0;
  const long long grid = (R + RT_REGION_ROWS - 1) / RT_REGION_ROWS;
  const size_t smem = sizeof(float) * (2 * (size_t)RT_RED_FLOATS +
                                       (gws ? 0 : (size_t)ws_floats));
  if (smem > 48 * 1024 - RT_SMEM_STATIC) {
    // above 48 KB with the static arrays a kernel must opt in, once per
    // device
    static bool opted[64] = {false};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64 || !opted[dev]) {
      cudaFuncAttributes attr;
      e = cudaFuncGetAttributes(&attr, region_bwd_kernel);
      if (e != cudaSuccess) return (int)e;
      e = cudaFuncSetAttribute(
          region_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          RT_SMEM_BYTES - (int)attr.sharedSizeBytes);
      if (e != cudaSuccess) return (int)e;
      if (dev < 64) opted[dev] = true;
    }
  }
  region_bwd_kernel<<<(unsigned)grid, RT_REGION_THREADS, smem,
                      (cudaStream_t)stream>>>(prog, fc, n_instr, io_off, n_io,
                                              P, R, ws_floats, cot_off,
                                              gws, part_floats, gpart);
  return (int)cudaGetLastError();
}

extern "C" int rt_region_bwd_reduce(const float* part, long long G,
                                    long long P, float* out, void* stream) {
  if (G < 0 || P < 0) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const long long grid = (P + 255) / 256;
  region_bwd_reduce_kernel<<<(unsigned)grid, 256, 0, (cudaStream_t)stream>>>(
      part, G, P, out);
  return (int)cudaGetLastError();
}
