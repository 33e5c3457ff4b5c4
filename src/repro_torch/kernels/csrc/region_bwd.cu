// region_bwd: the backward of one fused region as ONE launch, plus a
// reduction launch when the region spans more than one row tile.
//
// Replaces the TPU kernel repro/kernels/region.py::_region_bwd_kernel (kernel
// body at region.py:347, pallas_call at :435 in _region_bwd_call :393), the
// backward that region_grad_fn (:451) gives the fit path's region call.  The
// TPU kernel replays the step program under jax.vjp per row tile and carries
// the parameter cotangents across its sequential grid in VMEM.  Here tiles
// run in parallel and in no order, so nothing carries over: each
// RT_REGION_ROWS-row tile runs on a thread-block cluster of C CTAs (as in
// rt_region, region_steps.cuh), and each CTA owns a column block of every
// value, of its cotangent and of every mm output.  The cluster
//   1. replays the forward step program (the same chain_step / mm_step as
//      the forward kernel, weights through the same cp.async ring), keeping
//      EVERY value in its own slot (no liveness packing: the reverse walk
//      reads them all) and, for each sin epilogue, the argument h of
//      sin(w0 h), in the owner's shared memory;
//   2. walks a backward table in reverse step order, adding into
//      zero-initialised cotangent slots, one per value (stream inputs and
//      bcast rows included), split over the CTAs like the values;
//   3. writes its rows' stream cotangents, and the sums over its rows of
//      the bcast-row and resident cotangents to the cluster's own slice of
//      a partial buffer.  A second launch (rt_region_bwd_reduce) adds the
//      partials in tile order; with one tile (the fit path's 8-row block)
//      the partial is the result and the wrapper skips it.  No atomics
//      anywhere, so the result is the same bit for bit from run to run.
// Rules per step (kernels/region.py::lower_bwd writes the tables):
//   mm:    on the CTA's own output columns: dpre = dout * cos(w0 pre) * w0
//          when the epilogue applies sin (written over dout in place, so an
//          accumulating tile of a column-tiled reducer, flag 2, hands it on
//          unchanged to the tiles before it); db += sum_rows dpre.  After a
//          cluster barrier each CTA gathers x and dpre whole through
//          distributed shared memory: dW[k0:, own columns] += x^T dpre (a
//          read-modify-write of the cluster's partial), and on its own
//          columns of x's cotangent dx += dpre W^T, with W's rows of those
//          columns staged through the ring (phase 1 chunks).  dx sums over n
//          in an order fixed by the shape, as the forward sums over k.
//   chain: each CTA recomputes the chain's intermediates per element of its
//          own output columns, then pulls back through each opcode
//          (chain_op_bwd, with JAX's rules at the edges: max/min, relu
//          included, split ties evenly; abs passes g where x >= 0, so 1 at
//          0, as jnp.abs's rule does) and adds into the operands' cotangent
//          columns, wherever they live.  A chain with an operand read with
//          column stride 0 (one column broadcast) sums that operand's
//          cotangent over all columns: it runs whole on rank 0, one warp
//          per row with a warp reduction, so the order does not depend on C.
//          bcast rows (row stride 0) collect a per-row cotangent that step 3
//          sums over rows.
//   concat: a chain of no ops into a column range, so the cotangent splits
//          by column range.
//
// What bounds it on the H100: the true bound of one 8-row launch is ~1 us
// (each weight read once and its cotangent written once at 3.35 TB/s; the
// flops at 67 TFLOP/s take less).  At R = 8 a launch is latency-bound: 2 x
// 47 dependent steps at order 2.  The cluster spreads each step over C
// SMs; values and cotangents (0.73 MB per tile at full-width order 2) fit
// in the cluster's shared memory at C = 16 (45.6 KB per CTA), and the
// weights of every step reach shared memory through the ring ahead of use.
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
// space, slot offset, row stride (the slot's block width), column offset,
// column stride.
//   chain: [0..4] out, [5..9] x, [10+5e..] extra e
//   mm:    [0..4] out, [5..9] x, [10] pre slot or -1, [11] W's offset in
//          the partial buffer, [12] the bias's or -1

// The chain's intermediates at one element and the pullback of g through
// them: returns x's cotangent, writes the extras' to de.
__device__ __forceinline__ float chain_pullback(const int* ops,
                                                const float* vals, int n_ops,
                                                int n_extra, float h,
                                                const float* ev, float g,
                                                float* de) {
  float hs[RT_MAX_CHAIN + 1];
  int e = 0;
  for (int i = 0; i < n_ops; ++i) {
    hs[i] = h;
    const bool bin = ops[i] >= OP_MUL;
    const float xe = bin ? ev[e] : 0.f;
    h = eval_chain(h, 1, ops + i, vals + i, [&](int) { return xe; });
    if (bin) ++e;
  }
  hs[n_ops] = h;
  for (int i = n_ops - 1; i >= 0; --i) {
    const bool bin = ops[i] >= OP_MUL;
    if (bin) --e;
    float d = 0.f;
    g = chain_op_bwd(ops[i], hs[i], hs[i + 1], vals[i], bin ? ev[e] : 0.f, g,
                     &d);
    if (bin) de[e] = d;
  }
  return g;
}

// A chain with a broadcast-column operand, whole on one CTA: one warp per
// row, lanes over columns; a broadcast operand's cotangent sums the lanes'
// partials (columns lane, lane + 32, ...) through a warp reduction.
__device__ void chain_bwd_whole(const int* I, const int* B, const int* ops,
                                const float* vals, const LaneTable& P,
                                const Cta& c) {
  const int C = I[1], n_ops = I[2], n_extra = I[5];
  const int r = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= c.rows) return;  // whole warps: one warp per row
  const int xcs = I[15];
  float sx = 0.f, se[RT_MAX_EXTRA];
  for (int e = 0; e < n_extra; ++e) se[e] = 0.f;
  for (int col = lane; col < C; col += 32) {
    float ev[RT_MAX_EXTRA], de[RT_MAX_EXTRA];
    for (int e = 0; e < n_extra; ++e) ev[e] = *at(c, P, I + 16 + 5 * e, r, col);
    const float g = chain_pullback(ops, vals, n_ops, n_extra,
                                   *at(c, P, I + 11, r, col), ev,
                                   *at(c, P, B, r, col), de);
    if (xcs) *at(c, P, B + 5, r, col) += g; else sx += g;
    for (int k = 0; k < n_extra; ++k) {
      if (I[20 + 5 * k]) *at(c, P, B + 10 + 5 * k, r, col) += de[k];
      else se[k] += de[k];
    }
  }
  if (!xcs) {
    sx = warp_sum(sx);
    if (lane == 0) *at(c, P, B + 5, r, 0) += sx;
  }
  for (int e = 0; e < n_extra; ++e) {
    if (I[20 + 5 * e]) continue;
    const float s = warp_sum(se[e]);
    if (lane == 0) *at(c, P, B + 10 + 5 * e, r, 0) += s;
  }
}

__device__ void chain_bwd(const int* I, const int* B, const int* prog,
                          const float* fc, const LaneTable& P, const Cta& c) {
  const int C = I[1], n_ops = I[2], n_extra = I[5];
  const int* ops = prog + I[3];
  const float* vals = fc + I[4];
  bool whole = I[15] == 0;
  for (int e = 0; e < n_extra; ++e) whole |= I[20 + 5 * e] == 0;
  if (whole) {
    if (c.rank == 0) chain_bwd_whole(I, B, ops, vals, P, c);
    return;
  }
  int lo, hi;
  owned(c, B, C, lo, hi);
  const int w = hi - lo;
  for (int i = threadIdx.x; i < c.rows * w; i += blockDim.x) {
    const int r = i / w, col = lo + i - r * w;
    float ev[RT_MAX_EXTRA], de[RT_MAX_EXTRA];
    for (int e = 0; e < n_extra; ++e) ev[e] = *at(c, P, I + 16 + 5 * e, r, col);
    const float g = chain_pullback(ops, vals, n_ops, n_extra,
                                   *at(c, P, I + 11, r, col), ev,
                                   *at(c, P, B, r, col), de);
    *at(c, P, B + 5, r, col) += g;
    for (int k = 0; k < n_extra; ++k) *at(c, P, B + 10 + 5 * k, r, col) += de[k];
  }
}

#define BW_RMW 8  // dW read-modify-writes a thread keeps in flight

// dx on the block [kb, kb + nk) of the CTA's own columns of x's cotangent:
// dx[r, k] += sum_n dpre[r, n] W[k0 + k, n0 + n], ks = split_of(K) partial
// sums over n = q, q + ks, ... added in order.  w holds row kb (row stride
// ldr: N + 1 in the stage, W's own from L2 when kGlobal), dpre is in S.ds.
template <int RPT, bool kGlobal>
__device__ __forceinline__ void dx_block(const int* B, const LaneTable& P,
                                         const Cta& c, const Smem& S,
                                         const float* w, int ldr, int N, int K,
                                         int kb, int nk) {
  const int ks = split_of(K);
  const int items = (RT_REGION_ROWS / RPT) * ks * nk;
  const int t = threadIdx.x;
  const bool active = t < items;
  const int j = active ? t % nk : 0;
  const int rest = active ? t / nk : 0;
  const int q = rest % ks, rg = rest / ks;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  if (active && ks == 1 && (N & 3) == 0) {
    // one fma chain in n: dpre as float4
    const float* wr = w + (long long)j * ldr;
    const float* d0 = S.ds + rg * RPT * N;
#pragma unroll 4
    for (int n = 0; n < N; n += 4) {
      const float w0 = wld<kGlobal>(wr + n), w1 = wld<kGlobal>(wr + n + 1),
                  w2 = wld<kGlobal>(wr + n + 2), w3 = wld<kGlobal>(wr + n + 3);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 d4 = *reinterpret_cast<const float4*>(d0 + i * N + n);
        acc[i] = fmaf(d4.x, w0, acc[i]);
        acc[i] = fmaf(d4.y, w1, acc[i]);
        acc[i] = fmaf(d4.z, w2, acc[i]);
        acc[i] = fmaf(d4.w, w3, acc[i]);
      }
    }
  } else if (active) {
    const float* wr = w + (long long)j * ldr;
    const float* d0 = S.ds + rg * RPT * N;
#pragma unroll 4
    for (int n = q; n < N; n += ks) {
      const float wv = wld<kGlobal>(wr + n);
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = fmaf(d0[i * N + n], wv, acc[i]);
    }
  }
  reduce_partials<RPT>(S.red, ks, nk, active, q, rg, j, acc);
  if (!active || q != 0) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg * RPT + i;
    if (r >= c.rows) break;
    *at(c, P, B + 5, r, kb + j) += acc[i];
  }
}

__device__ void mm_bwd(const int* I, const int* B, const float* fc,
                       const LaneTable& P, const Cta& c, const Smem& S,
                       WRing& ring, float* part) {
  const int N = I[1], K = I[2];
  const int ldw = I[4], k0 = I[5], n0 = I[6], flags = I[8];
  const float w0 = fc[I[9]];
  const int t = threadIdx.x;
  int lo, hi;
  owned(c, B, N, lo, hi);
  const int ncw = hi - lo;
  if ((flags & 4) && (flags & 1)) {
    // the pre slot has the out slot's layout: [rows, cw], first column
    // rank * cw
    const float* pre = c.ws + B[10];
    const int base = c.rank * B[2] - B[3];
    for (int i = t; i < c.rows * ncw; i += blockDim.x) {
      const int r = i / ncw, n = lo + i - r * ncw;
      float* gp = at(c, P, B, r, n);
      *gp = (*gp * cosf(w0 * pre[r * B[2] + n - base])) * w0;
    }
    __syncthreads();
  }
  if ((flags & 4) && B[12] >= 0) {
    float* db = part + B[12] + n0;
    for (int n = lo + t; n < hi; n += blockDim.x) {
      float s = 0.f;
      for (int r = 0; r < c.rows; ++r) s += *at(c, P, B, r, n);
      db[n] += s;
    }
  }
  cluster_barrier(c);  // every CTA's dpre is in place
  gather(c, P, I + 15, K, S.xs);
  gather(c, P, B, N, S.ds);
  __syncthreads();
  // dW[k, n] += sum_r x[r, k] dpre[r, n] on the own columns n, every k; a
  // thread keeps BW_RMW read-modify-writes in flight (rows past the tile
  // are zeros, so every sum runs over 8 rows in order)
  if (ncw > 0) {
    float* dW = part + B[11] + (long long)k0 * ldw + n0;
    const int total = K * ncw;
    for (int i0 = t; i0 < total; i0 += BW_RMW * blockDim.x) {
      float old[BW_RMW], s[BW_RMW];
      float* dst[BW_RMW];
#pragma unroll
      for (int u = 0; u < BW_RMW; ++u) {
        const int i = i0 + u * blockDim.x;
        const int k = i / ncw, n = lo + i - (i / ncw) * ncw;
        dst[u] = i < total ? dW + (long long)k * ldw + n : nullptr;
        old[u] = dst[u] ? *dst[u] : 0.f;
        s[u] = 0.f;
        if (dst[u]) {
#pragma unroll
          for (int r = 0; r < RT_REGION_ROWS; ++r)
            s[u] = fmaf(S.xs[r * K + k], S.ds[r * N + n], s[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < BW_RMW; ++u)
        if (dst[u]) *dst[u] = old[u] + s[u];
    }
  }
  // dx on the own columns of x's cotangent, W's rows through the ring
  int klo, khi;
  owned(c, B + 5, K, klo, khi);
  const int nk = khi - klo;
  if (nk <= 0) {
    if (ring.on) {
      ring.wait();
      ring.release(c, P);
    }
    return;
  }
  const int ks = split_of(K);
  int kr = ring.on ? RT_WSTAGE_FLOATS / (N + 1) : nk;
  if (kr > RT_REGION_THREADS / ks) kr = RT_REGION_THREADS / ks;
  const float* Wg = tensor(P, I[3], 0) + (long long)k0 * ldw + n0;
  for (int kb = klo; kb < khi; kb += kr) {
    const int n_k = khi - kb < kr ? khi - kb : kr;
    if (ring.on) {
      const float* w = ring.wait();
      switch (rows_per_thread(ks, n_k)) {
        case 1: dx_block<1, false>(B, P, c, S, w, N + 1, N, K, kb, n_k); break;
        case 2: dx_block<2, false>(B, P, c, S, w, N + 1, N, K, kb, n_k); break;
        case 4: dx_block<4, false>(B, P, c, S, w, N + 1, N, K, kb, n_k); break;
        default: dx_block<8, false>(B, P, c, S, w, N + 1, N, K, kb, n_k); break;
      }
      ring.release(c, P);
    } else {  // a one-CTA cluster reads W's rows from L2
      const float* w = Wg + (long long)kb * ldw;
      switch (rows_per_thread(ks, n_k)) {
        case 1: dx_block<1, true>(B, P, c, S, w, ldw, N, K, kb, n_k); break;
        case 2: dx_block<2, true>(B, P, c, S, w, ldw, N, K, kb, n_k); break;
        case 4: dx_block<4, true>(B, P, c, S, w, ldw, N, K, kb, n_k); break;
        default: dx_block<8, true>(B, P, c, S, w, ldw, N, K, kb, n_k); break;
      }
      __syncthreads();  // red is free for the next block
    }
  }
}

// grid (tiles x C): cluster b owns rows [8 b, 8 b + 8) and the partial
// slice gpart[b * part_floats, (b + 1) * part_floats).  io entries
// (RT_BWD_IO_INTS ints): [kind, a, width, slot] with kind 0 = seed the slot
// from output cotangent tensor a, 1 = write the slot to stream cotangent
// tensor a, 2 = sum the slot's rows into the partial at offset a; each CTA
// on its own column block of the slot.
__global__ void __launch_bounds__(RT_REGION_THREADS)
    region_bwd_kernel(const int* __restrict__ gprog,
                      const float* __restrict__ gfc, int n_instr, int io_off,
                      int n_io, LaneTable P, long long R, int ws_floats,
                      int cot_off, int xs_floats, int ds_floats,
                      int table_ints, int fc_floats, float* gws,
                      long long part_floats, float* gpart) {
  extern __shared__ __align__(16) float smem[];
  Cta c;
  c.rank = (int)cg::this_cluster().block_rank();
  c.csize = (int)cg::this_cluster().num_blocks();
  c.lane = 0;
  const long long tile = blockIdx.x / c.csize;
  c.row0 = tile * RT_REGION_ROWS;
  const long long left = R - c.row0;
  c.rows = left < RT_REGION_ROWS ? (int)left : RT_REGION_ROWS;
  c.ws_floats = ws_floats;
  Smem S;
  S.red = smem;
  S.xs = smem + RT_RED_FLOATS;
  S.ds = S.xs + xs_floats;
  WRing ring;
  ring.on = c.csize > 1;
  ring.stage = S.ds + ds_floats;
  float* lws = ring.stage + (ring.on ? RT_WRING * RT_WSTAGE_FLOATS : 0);
  if (gws) {
    c.gws = gws + tile * c.csize * ws_floats;
    c.ws = c.gws + (long long)c.rank * ws_floats;
  } else {
    c.gws = nullptr;
    c.ws = lws;
  }
  const int* prog = gprog;
  const float* fc = gfc;
  stage_tables(prog, fc, table_ints, fc_floats,
               reinterpret_cast<int*>(lws + (gws ? 0 : ws_floats)),
               2LL * n_instr * RT_INSTR_INTS * sizeof(int));
  const int* bwd = prog + (long long)n_instr * RT_INSTR_INTS;
  ring.prog = prog;
  ring.bwd = bwd;
  ring.n_instr = n_instr;
  float* part = gpart + tile * part_floats;
  const int* io = prog + io_off;
  const int t = threadIdx.x;
  ring.start(c, P);
  for (long long i = (long long)c.rank * blockDim.x + t; i < part_floats;
       i += (long long)c.csize * blockDim.x)
    part[i] = 0.f;
  // the cotangent slots start at cot_off; value slots are written first
  for (int i = cot_off + t; i < ws_floats; i += blockDim.x) c.ws[i] = 0.f;
  __syncthreads();
  for (int j = 0; j < n_io; ++j) {
    const int* e = io + RT_BWD_IO_INTS * j;
    if (e[0] != 0) continue;
    const int W = e[2], cw = cdiv_i(W, c.csize), lo = c.rank * cw;
    const int w = W - lo < cw ? W - lo : cw;
    if (w <= 0) continue;
    const float* src = tensor(P, e[1], 0) + c.row0 * W + lo;
    float* dst = c.ws + e[3];
    for (int i = t; i < c.rows * w; i += blockDim.x) {
      const int r = i / w, u = i - r * w;
      dst[r * cw + u] += src[(long long)r * W + u];
    }
  }
  cluster_barrier(c);  // partials zeroed, every CTA running
  for (int s = 0; s < n_instr; ++s) {
    const int* I = prog + (long long)s * RT_INSTR_INTS;
    const int* B = bwd + (long long)s * RT_INSTR_INTS;
    if (I[0] == 0)
      chain_step(I, prog, fc, P, c);
    else
      mm_step<true>(I, fc, P, c, S, ring, B[10] >= 0 ? c.ws + B[10] : nullptr);
    cluster_barrier(c);
  }
  for (int s = n_instr - 1; s >= 0; --s) {
    const int* I = prog + (long long)s * RT_INSTR_INTS;
    const int* B = bwd + (long long)s * RT_INSTR_INTS;
    if (I[0] == 0)
      chain_bwd(I, B, prog, fc, P, c);
    else
      mm_bwd(I, B, fc, P, c, S, ring, part);
    cluster_barrier(c);
  }
  for (int j = 0; j < n_io; ++j) {
    const int* e = io + RT_BWD_IO_INTS * j;
    const int W = e[2], cw = cdiv_i(W, c.csize), lo = c.rank * cw;
    const int w = W - lo < cw ? W - lo : cw;
    if (e[0] == 0 || w <= 0) continue;
    const float* src = c.ws + e[3];
    if (e[0] == 1) {
      float* dst = const_cast<float*>(tensor(P, e[1], 0)) + c.row0 * W + lo;
      for (int i = t; i < c.rows * w; i += blockDim.x) {
        const int r = i / w, u = i - r * w;
        dst[(long long)r * W + u] = src[r * cw + u];
      }
    } else {
      for (int u = t; u < w; u += blockDim.x) {
        float s = 0.f;
        for (int r = 0; r < c.rows; ++r) s += src[r * cw + u];
        part[e[1] + lo + u] = s;
      }
    }
  }
  ring.drain();
}

// out[i] = sum over tiles b, in order, of part[b * P + i]
__global__ void region_bwd_reduce_kernel(const float* __restrict__ part,
                                         long long G, long long P,
                                         float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  float s = 0.f;
  for (long long b = 0; b < G; ++b) s += part[b * P + i];
  out[i] = s;
}

static bool g_bwd_opted[64] = {false};

extern "C" int rt_region_bwd(const int* prog, const float* fc, int n_instr,
                             int io_off, int n_io, int n_ptrs,
                             const long long* ptrs, long long R, int ws_floats,
                             int cot_off, int xs_floats, int ds_floats,
                             int table_ints, int fc_floats, int C, float* gws,
                             long long part_floats, float* gpart,
                             void* stream) {
  if (n_ptrs < 0 || n_ptrs > RT_MAX_PTRS || ws_floats < 0 || n_io < 0 ||
      part_floats < 0 || cot_off < 0 || cot_off > ws_floats ||
      xs_floats < 0 || (xs_floats & 3) || ds_floats < 0 || (ds_floats & 3) ||
      C < 1 || C > RT_MAX_CLUSTER || table_ints < 0 || fc_floats < 0)
    return (int)cudaErrorInvalidValue;
  LaneTable P;
  for (int i = 0; i < RT_MAX_PTRS; ++i) {
    P.p[i] = i < n_ptrs ? reinterpret_cast<const float*>(ptrs[i]) : nullptr;
    P.stride[i] = 0;
  }
  if (R <= 0) return 0;
  const long long tiles = (R + RT_REGION_ROWS - 1) / RT_REGION_ROWS;
  const size_t smem = region_smem(xs_floats, ds_floats, ws_floats,
                                  gws == nullptr, C, table_ints, fc_floats);
  cudaError_t e = region_attributes(region_bwd_kernel, g_bwd_opted);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, dim3((unsigned)(tiles * C)), C, smem, stream);
  e = cudaLaunchKernelEx(&cfg, region_bwd_kernel, prog, fc, n_instr, io_off,
                         n_io, P, R, ws_floats, cot_off, xs_floats, ds_floats,
                         table_ints, fc_floats, gws, part_floats, gpart);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters of the backward kernel (see
// rt_region_max_clusters).
extern "C" int rt_region_bwd_max_clusters(int C, long long smem) {
  if (C < 1 || C > RT_MAX_CLUSTER || smem < 0)
    return -(int)cudaErrorInvalidValue;
  cudaError_t e = region_attributes(region_bwd_kernel, g_bwd_opted);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, dim3((unsigned)C), C, (size_t)smem, nullptr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, region_bwd_kernel, &cfg);
  return e == cudaSuccess ? n : -(int)e;
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
