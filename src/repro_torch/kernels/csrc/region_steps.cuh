// The step interpreter shared by region.cu (the forward) and region_bwd.cu
// (whose first pass replays the forward): the pointer table, the CTA's place
// in its thread-block cluster, views, the weight ring, and the chain and mm
// steps of a region program.  kernels/region.py writes the instruction
// tables these functions read.
//
// Column ownership.  A launch runs each RT_REGION_ROWS-row tile on a cluster
// of C CTAs (C = the cluster's size, chosen per shape by the wrapper).  Every
// value of width w is cut into C blocks of cw = ceil(w / C) columns; CTA q of
// the cluster owns block q.  A workspace value lives in its owner's shared
// memory as a [RT_REGION_ROWS, cw] slot (the lowering gives its views row
// stride cw, so a view names its own block width); a kernel operand or
// output is a global tensor, owned in blocks of ceil(row stride / C).  A CTA
// writes only the columns it owns and reads any column through at():
// its own shared memory, another CTA's through distributed shared memory
// (map_shared_rank), or global memory.  Steps are separated by cluster
// barriers (release / acquire at cluster scope), so what one CTA wrote is
// what the next step reads on any CTA.
//
// Summation order.  Every output element of an mm step is summed in an
// order fixed by the step's shape alone: ks = split_of(N) partial sums over
// k = q, q + ks, ... (each an fmaf chain from 0), added in order q = 0..ks-1.
// Which CTA or thread computes it, how many CTAs share the tile (C) and how
// many rows or lanes the launch has do not enter, so a K-lane launch equals
// K single-lane launches bit for bit whatever C each one picks.
#pragma once

#include <cooperative_groups.h>

#include "abi.cuh"
#include "mbarrier.cuh"

namespace cg = cooperative_groups;

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

__device__ __forceinline__ int cdiv_i(int a, int b) { return (a + b - 1) / b; }

// ks of an mm step with `cols` output columns: pw threads across columns
// (the power of two >= cols, at most a CTA), ksplit = CTA / pw, at most 32
__device__ __forceinline__ int split_of(int cols) {
  int pw = 1;
  while (pw < cols && pw < RT_REGION_THREADS) pw <<= 1;
  const int ks = RT_REGION_THREADS / pw;
  return ks > 32 ? 32 : ks;
}

// One CTA's place: its cluster rank and size, its lane and row tile, and
// where the cluster's workspaces live (shared memory, or a global slice per
// CTA when the wrapper found no room).
struct Cta {
  float* ws;         // this CTA's workspace
  float* gws;        // the cluster's global workspaces (rank 0's), or null
  int ws_floats;
  int rank, csize;
  long long lane, row0;
  int rows;          // rows of the tile (< RT_REGION_ROWS on a ragged one)
};

__device__ __forceinline__ float* ws_of(const Cta& c, int q) {
  if (q == c.rank) return c.ws;
  if (c.gws) return c.gws + (long long)q * c.ws_floats;
  return cg::this_cluster().map_shared_rank(c.ws, q);
}

__device__ __forceinline__ void cluster_barrier(const Cta& c) {
  if (c.csize == 1) {
    __syncthreads();
  } else {
    // arrive has release and wait acquire semantics at cluster scope: the
    // CTA's shared and global writes before it are visible after it
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  }
}

// A view is 5 ints: space (0 = a tensor of the pointer table, 1 = the
// workspace), index (pointer-table index or slot offset in floats), row
// stride (a workspace slot's is its block width cw), column offset, column
// stride (0 broadcasts one column).  Rows of a tensor view start at the
// tile's first row; a row stride of 0 broadcasts one [1, C] row.
// Element (r, col) of the view:
__device__ __forceinline__ float* at(const Cta& c, const LaneTable& P,
                                     const int* v, int r, int col) {
  const int cc = v[3] + col * v[4];
  if (!v[0])
    return const_cast<float*>(tensor(P, v[1], c.lane)) +
           (c.row0 + r) * v[2] + cc;
  const int q = cc / v[2];
  return ws_of(c, q) + v[1] + r * v[2] + (cc - q * v[2]);
}

// The view columns [lo, hi) of `cols` whose value columns this CTA owns.
__device__ __forceinline__ void owned(const Cta& c, const int* v, int cols,
                                      int& lo, int& hi) {
  const int cw = v[0] ? v[2] : cdiv_i(v[2], c.csize);
  lo = c.rank * cw - v[3];
  hi = lo + cw;
  if (lo < 0) lo = 0;
  if (hi > cols) hi = cols;
}

// Instruction layouts (RT_INSTR_INTS ints each); kernels/region.py writes them.
//   chain: [0]=0 [1]=cols [2]=n_ops [3]=ops offset (ints of prog)
//          [4]=constants offset (floats of fc) [5]=n_extra
//          [6..10]=out view [11..15]=x view [16+5e..]=extra view e
//   mm:    [0]=1 [1]=N [2]=K [3]=W pointer [4]=W row stride [5]=W first row
//          [6]=W first column [7]=bias pointer or -1 [8]=flags
//          (1 sin, 2 accumulate into out, 4 epilogue) [9]=w0 offset (fc)
//          [10..14]=out view [15..19]=x view [20]=1 when a row-cluster
//          launch streams W through its ring (region.cu)
// A backward table (region_bwd.cu) sits beside the forward one; an mm's
// backward entry holds the cotangent view of its x at [5..9].

// ---------------------------------------------------------------------------
// The weight ring: RT_WRING stages of RT_WSTAGE_FLOATS floats in shared
// memory, filled by cp.async in the order the steps consume them, so the
// next chunk of weights is in flight while the current step (and the chain
// steps before the next mm) run.  A chunk is one of
//   phase 0 (an mm's forward): rows [k, k + kr) of W[k0:k0+K, n0+lo : n0+hi]
//     for the CTA's output columns [lo, hi), in column blocks of at most
//     RT_REGION_THREADS, stored [kr][block width];
//   phase 1 (an mm's dx, region_bwd): rows [k, k + kr) of the CTA's own
//     x-cotangent columns, all N columns W[k0+k, n0 : n0+N], stored with
//     row stride N + 1 (so a warp reading one column of many rows hits 32
//     banks).
// A step with no columns on this CTA still takes one (empty) chunk, so
// every CTA walks its own sequence in program order.
// ---------------------------------------------------------------------------

// The layout of one chunk, from its instruction and phase.
struct Chunk {
  const float* src;  // first element (row k, first column)
  int ldw;           // W's row stride
  int rows, cols;    // rows copied, columns per row
  int ld;            // row stride in the stage
  int n;             // phase 0: chunks of the step; phase 1 too
};

// Phase 0: the CTA's output columns of an mm are [lo, hi); column blocks of
// at most RT_REGION_THREADS, each walked in chunks of kr rows.
// (a multiple of 4, so float4 loads of x stay aligned)
__device__ __forceinline__ int fwd_block_rows(int bw) {
  return (RT_WSTAGE_FLOATS / (bw > 0 ? bw : 1)) & ~3;
}

struct WRing {
  bool on;  // off: every step reads W from L2 (a row cluster's narrow mm)
  float* stage;
  const int* prog;
  const int* bwd;  // the backward table (phase 1 chunks), or null
  int n_instr;
  int issued, consumed;
  int ps, pphase, pj;  // the producer's cursor: step, phase, chunk

  // Chunk j of step I (forward table) in phase `phase`, B its backward
  // entry: false past the step's last chunk (ch.n chunks in all).
  __device__ __forceinline__ bool chunk(const Cta& c, const LaneTable& P,
                                        const int* I, const int* B, int phase,
                                        int j, Chunk& ch) const {
    const int N = I[1], K = I[2], ldw = I[4], k0 = I[5], n0 = I[6];
    const float* W = tensor(P, I[3], c.lane);
    ch.ldw = ldw;
    if (phase == 0) {
      int lo, hi;
      owned(c, I + 10, N, lo, hi);
      const int ncw = hi - lo;
      if (ncw <= 0) {
        ch.n = 1;
        ch.rows = 0;
        return j < 1;
      }
      const int nblk = cdiv_i(ncw, RT_REGION_THREADS);
      // chunks per block: the last block may be narrower, but every block
      // uses the widest block's row count so the count is one product
      const int bw0 = ncw < RT_REGION_THREADS ? ncw : RT_REGION_THREADS;
      const int kr = fwd_block_rows(bw0);
      const int per = cdiv_i(K, kr);
      ch.n = nblk * per;
      if (j >= ch.n) return false;
      const int b = j / per, kb = j - b * per;
      const int c0 = lo + b * RT_REGION_THREADS;
      const int bw = hi - c0 < RT_REGION_THREADS ? hi - c0 : RT_REGION_THREADS;
      const int k = kb * kr;
      ch.rows = K - k < kr ? K - k : kr;
      ch.cols = bw;
      ch.ld = bw;
      ch.src = W + (long long)(k0 + k) * ldw + n0 + c0;
      return true;
    }
    int klo, khi;
    owned(c, B + 5, K, klo, khi);
    const int nk = khi - klo;
    if (nk <= 0) {
      ch.n = 1;
      ch.rows = 0;
      return j < 1;
    }
    int kr = RT_WSTAGE_FLOATS / (N + 1);
    const int cap = RT_REGION_THREADS / split_of(K);
    if (kr > cap) kr = cap;
    ch.n = cdiv_i(nk, kr);
    if (j >= ch.n) return false;
    const int k = klo + j * kr;
    ch.rows = khi - k < kr ? khi - k : kr;
    ch.cols = N;
    ch.ld = N + 1;
    ch.src = W + (long long)(k0 + k) * ldw + n0;
    return true;
  }

  // Copy the next chunk of the sequence into its stage (every thread takes
  // its share) and commit one cp.async group, empty past the end.
  __device__ __forceinline__ void issue(const Cta& c, const LaneTable& P) {
    while (true) {
      if (pphase == 0 && ps >= n_instr) {
        if (!bwd) break;
        pphase = 1;
        ps = n_instr - 1;
        pj = 0;
        continue;
      }
      if (pphase == 1 && ps < 0) break;
      const int* I = prog + (long long)ps * RT_INSTR_INTS;
      const int* B = bwd ? bwd + (long long)ps * RT_INSTR_INTS : nullptr;
      Chunk ch;
      if (I[0] != 1 || !chunk(c, P, I, B, pphase, pj, ch)) {
        ps += pphase == 0 ? 1 : -1;
        pj = 0;
        continue;
      }
      ++pj;
      float* dst = stage + (issued % RT_WRING) * RT_WSTAGE_FLOATS;
      const int t = threadIdx.x;
      if (ch.rows > 0) {
        const bool vec = pphase == 0 && (ch.cols & 3) == 0 &&
                         (ch.ldw & 3) == 0 &&
                         (reinterpret_cast<size_t>(ch.src) & 15) == 0;
        if (vec) {
          const int q4 = ch.cols >> 2;
          for (int i = t; i < ch.rows * q4; i += blockDim.x) {
            const int r = i / q4, u = i - r * q4;
            cp_async16(dst + r * ch.ld + 4 * u,
                       ch.src + (long long)r * ch.ldw + 4 * u);
          }
        } else {
          for (int i = t; i < ch.rows * ch.cols; i += blockDim.x) {
            const int r = i / ch.cols, u = i - r * ch.cols;
            cp_async4(dst + r * ch.ld + u, ch.src + (long long)r * ch.ldw + u);
          }
        }
      }
      break;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    ++issued;
  }

  __device__ __forceinline__ void start(const Cta& c, const LaneTable& P) {
    if (!on) return;
    issued = consumed = 0;
    ps = 0;
    pphase = 0;
    pj = 0;
    for (int i = 0; i < RT_WRING; ++i) issue(c, P);
  }

  // The next chunk in the sequence, once it has landed (every thread's
  // copies: wait for the group, then the CTA barrier).
  __device__ __forceinline__ const float* wait() {
    if (!on) return nullptr;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(RT_WRING - 1) : "memory");
    __syncthreads();
    return stage + (consumed % RT_WRING) * RT_WSTAGE_FLOATS;
  }

  // Done with the current chunk: refill its stage with the chunk RT_WRING
  // places ahead.
  __device__ __forceinline__ void release(const Cta& c, const LaneTable& P) {
    if (!on) return;
    __syncthreads();
    ++consumed;
    issue(c, P);
  }

  __device__ __forceinline__ void drain() {
    if (!on) return;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
};

// The launch's shared memory: partial sums of the mm steps, the gathered x
// (and, in region_bwd, the gathered dpre), the weight ring.
struct Smem {
  float* red;  // RT_RED_FLOATS
  float* xs;   // RT_REGION_ROWS x (widest K), row stride K
  float* ds;   // region_bwd: RT_REGION_ROWS x (widest N)
};

// ---------------------------------------------------------------------------
// chain step: the CTA evaluates the elements of the columns it owns
// ---------------------------------------------------------------------------

// A view resolved once per step for the columns [lo, hi): element (r, col)
// at base[r * rs + col * cs] when those columns live in one place (a
// tensor, or one CTA's block); base is null when they span CTAs.
struct Flat {
  const float* base;
  int rs, cs;
};

__device__ __forceinline__ Flat flat_view(const Cta& c, const LaneTable& P,
                                          const int* v, int lo, int hi) {
  Flat f;
  f.rs = v[2];
  f.cs = v[4];
  if (!v[0]) {
    f.base = tensor(P, v[1], c.lane) + c.row0 * v[2] + v[3];
    return f;
  }
  const int q = (v[3] + lo * v[4]) / v[2];
  f.base = q == (v[3] + (hi - 1) * v[4]) / v[2]
               ? ws_of(c, q) + v[1] + v[3] - q * v[2]
               : nullptr;
  return f;
}

// NV: elements of a thread in flight at once on the common path (the row
// clusters' CTAs hold every column of their rows: many elements a thread)
template <int NV = 1>
__device__ __forceinline__ void chain_step(const int* I, const int* prog,
                                           const float* fc, const LaneTable& P,
                                           const Cta& c) {
  // decode the step once into shared memory instead of once per element:
  // its opcodes and constants, and where each operand's columns live
  __shared__ int s_ops[RT_MAX_CHAIN];
  __shared__ float s_vals[RT_MAX_CHAIN];
  __shared__ Flat s_op[RT_MAX_EXTRA + 2];  // out, x, extras
  const int cols = I[1], n_ops = I[2], n_extra = I[5];
  const int t = threadIdx.x;
  int lo, hi;
  owned(c, I + 6, cols, lo, hi);
  const int w = hi - lo;
  if (t < n_ops) {
    s_ops[t] = prog[I[3] + t];
    s_vals[t] = fc[I[4] + t];
  }
  if (w > 0 && t < n_extra + 2)
    s_op[t] = flat_view(c, P, t == 0 ? I + 6 : I + 11 + 5 * (t - 1), lo, hi);
  __syncthreads();
  if (w <= 0) return;
  bool flat = true;
  for (int e = 0; e < n_extra + 2; ++e) flat &= s_op[e].base != nullptr;
  if (NV == 1 && flat && n_extra <= 2) {
    // the common case: every operand in one place, at most two extras
    const Flat o = s_op[0], x = s_op[1], e0 = s_op[2], e1 = s_op[3];
    for (int i = t; i < c.rows * w; i += blockDim.x) {
      const int r = i / w, col = lo + i - r * w;
      const float h = x.base[r * x.rs + col * x.cs];
      const float a = n_extra > 0 ? e0.base[r * e0.rs + col * e0.cs] : 0.f;
      const float b = n_extra > 1 ? e1.base[r * e1.rs + col * e1.cs] : 0.f;
      const_cast<float*>(o.base)[r * o.rs + col] = eval_chain(
          h, n_ops, s_ops, s_vals, [&](int e) { return e ? b : a; });
    }
    return;
  }
  constexpr int kFlat = 4;  // extras the NV-wide path takes
  if (NV > 1 && flat && n_extra <= kFlat) {
    // every operand in one place, NV elements a thread at once
    const Flat o = s_op[0], x = s_op[1];
    Flat ev[kFlat];
#pragma unroll
    for (int e = 0; e < kFlat; ++e) ev[e] = s_op[2 + e];
    const int n = c.rows * w;
    // element i0 + v * blockDim.x is (r[v], col[v]); each round moves them
    // on by NV * blockDim.x elements (dr rows and dc columns, with carry)
    int r[NV], col[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      r[v] = (t + v * (int)blockDim.x) / w;
      col[v] = t + v * (int)blockDim.x - r[v] * w;
    }
    const int step = NV * blockDim.x, dr = step / w, dc = step - dr * w;
    for (int i0 = t; i0 < n; i0 += step) {
      float h[NV], ex[kFlat][NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const bool in = i0 + v * (int)blockDim.x < n;
        const int rv = in ? r[v] : r[0], cv = lo + (in ? col[v] : col[0]);
        h[v] = x.base[rv * x.rs + cv * x.cs];
#pragma unroll
        for (int e = 0; e < kFlat; ++e)
          ex[e][v] =
              n_extra > e ? ev[e].base[rv * ev[e].rs + cv * ev[e].cs] : 0.f;
      }
      eval_chain_n<NV>(h, n_ops, s_ops, s_vals, [&](int e, int v) {
        float a = ex[0][v];
#pragma unroll
        for (int q = 1; q < kFlat; ++q) a = e == q ? ex[q][v] : a;
        return a;
      });
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (i0 + v * (int)blockDim.x < n)
          const_cast<float*>(o.base)[r[v] * o.rs + lo + col[v]] = h[v];
        r[v] += dr;
        col[v] += dc;
        if (col[v] >= w) {
          col[v] -= w;
          ++r[v];
        }
      }
    }
    return;
  }
  for (int i = t; i < c.rows * w; i += blockDim.x) {
    const int r = i / w, col = lo + i - r * w;
    const float h = eval_chain(*at(c, P, I + 11, r, col), n_ops, s_ops,
                               s_vals, [&](int e) {
                                 return *at(c, P, I + 16 + 5 * e, r, col);
                               });
    *at(c, P, I + 6, r, col) = h;
  }
}

// x [rows, K] of a view into xs (row stride K), zeros past the tile's rows.
// GATHER loads in flight per thread before their stores: a remote CTA's
// shared memory answers in a few hundred cycles.
#define GATHER 8
__device__ __forceinline__ void gather(const Cta& c, const LaneTable& P,
                                       const int* v, int K, float* xs) {
  if (v[0] && !c.gws && v[4] == 1 && ((v[2] | v[3] | K) & 3) == 0) {
    // a workspace value in shared memory, blocks of 4-aligned columns:
    // 16-byte loads through the cluster's shared-memory window
    const int K4 = K >> 2, n4 = RT_REGION_ROWS * K4;
    const unsigned base = smem_u32(c.ws);
    for (int i0 = threadIdx.x; i0 < n4; i0 += GATHER * blockDim.x) {
      float4 val[GATHER];
#pragma unroll
      for (int u = 0; u < GATHER; ++u) {
        const int i = i0 + u * blockDim.x;
        const int r = i / K4, cc = v[3] + 4 * (i - r * K4);
        const int q = cc / v[2];
        val[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < n4 && r < c.rows) {
          const unsigned a =
              base + 4u * (unsigned)(v[1] + r * v[2] + cc - q * v[2]);
          unsigned ra;
          asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                       : "=r"(ra) : "r"(a), "r"(q));
          asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                       : "=f"(val[u].x), "=f"(val[u].y), "=f"(val[u].z),
                         "=f"(val[u].w)
                       : "r"(ra)
                       : "memory");
        }
      }
#pragma unroll
      for (int u = 0; u < GATHER; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < n4) reinterpret_cast<float4*>(xs)[i] = val[u];
      }
    }
    return;
  }
  const int n = RT_REGION_ROWS * K;
  for (int i0 = threadIdx.x; i0 < n; i0 += GATHER * blockDim.x) {
    float val[GATHER];
#pragma unroll
    for (int u = 0; u < GATHER; ++u) {
      const int i = i0 + u * blockDim.x;
      const int r = i / K, k = i - r * K;
      val[u] = i < n && r < c.rows ? *at(c, P, v, r, k) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < GATHER; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) xs[i] = val[u];
    }
  }
}

// Pull `bytes` of a read-only table into L1 ahead of its first use (the
// step program is read by every thread, step after step).
__device__ __forceinline__ void prefetch_l1(const void* p, long long bytes) {
  for (long long off = (long long)threadIdx.x * 128; off < bytes;
       off += (long long)blockDim.x * 128)
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(
        reinterpret_cast<const char*>(p) + off));
}

// The step program and its constants, copied into shared memory at `dst`
// when the launch staged them (table_ints > 0): every step then decodes
// its instruction from shared memory instead of waiting on L2.  Otherwise
// the tables stay where they are and L1 is asked for them ahead.
__device__ __forceinline__ void stage_tables(const int*& prog,
                                             const float*& fc, int table_ints,
                                             int fc_floats, int* dst,
                                             long long prefetch_bytes) {
  if (table_ints <= 0) {
    prefetch_l1(prog, prefetch_bytes);
    return;
  }
  float* dfc = reinterpret_cast<float*>(dst + ((table_ints + 3) & ~3));
  for (int i = threadIdx.x; i < table_ints; i += blockDim.x) dst[i] = prog[i];
  for (int i = threadIdx.x; i < fc_floats; i += blockDim.x) dfc[i] = fc[i];
  __syncthreads();
  prog = dst;
  fc = dfc;
}

// Work of one thread on an [8 rows] x [bw columns] block with ks partial
// sums per element: (8 / RPT) row groups x ks x bw items, columns fastest,
// the smallest RPT that keeps the items within one CTA.
__device__ __forceinline__ int rows_per_thread(int ks, int bw) {
  int rpt = 1;
  while (rpt < RT_REGION_ROWS &&
         (RT_REGION_ROWS / rpt) * ks * bw > RT_REGION_THREADS)
    rpt <<= 1;
  return rpt;
}

// A weight element: from the ring's stage, or (kGlobal: region_bwd's
// one-CTA launch, a row cluster's narrow mm) from L2 through the read-only
// path.
template <bool kGlobal>
__device__ __forceinline__ float wld(const float* p) {
  return kGlobal ? __ldg(p) : *p;
}

// acc[i] (row rg * RPT + i, column col, partial kp) += x[row, k] w[k, col]
// for k in [kb, ke), k = kp (mod ks), in increasing k.  w holds row kb of
// the block (row stride bw: the stage's block width, or W's row stride).
// kVec: a single chain (ks == 1) reads x four k at a time.
template <int RPT, bool kGlobal, bool kVec = true>
__device__ __forceinline__ void mm_accumulate(const float* xs, int K,
                                              const float* w, int bw, int kb,
                                              int ke, int ks, int kp, int rg,
                                              int col, float* acc) {
  const float* x0 = xs + rg * RPT * K;
  if (kVec && ks == 1 && (K & 3) == 0) {
    // one fma chain in k: x as float4 (chunks start at multiples of 4);
    // from L2, four rounds of loads in flight
#pragma unroll 4
    for (int k = kb; k < ke; k += 4) {
      const float* wk = w + (long long)(k - kb) * bw + col;
      const float w0 = wld<kGlobal>(wk), w1 = wld<kGlobal>(wk + bw),
                  w2 = wld<kGlobal>(wk + 2 * bw),
                  w3 = wld<kGlobal>(wk + 3 * bw);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 x4 = *reinterpret_cast<const float4*>(x0 + i * K + k);
        acc[i] = fmaf(x4.x, w0, acc[i]);
        acc[i] = fmaf(x4.y, w1, acc[i]);
        acc[i] = fmaf(x4.z, w2, acc[i]);
        acc[i] = fmaf(x4.w, w3, acc[i]);
      }
    }
    return;
  }
  int k = kb + ((kp - kb) % ks + ks) % ks;
#pragma unroll 4
  for (; k < ke; k += ks) {
    const float wv = wld<kGlobal>(w + (long long)(k - kb) * bw + col);
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = fmaf(x0[i * K + k], wv, acc[i]);
  }
}

// Sum the ks partials of every element in order q = 0..ks-1 (through red)
// and leave the sums in the kp == 0 threads' acc.
template <int RPT>
__device__ __forceinline__ void reduce_partials(float* red, int ks, int bw,
                                                bool active, int kp, int rg,
                                                int col, float* acc) {
  if (ks == 1) return;
  if (active) {
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      red[(kp * RT_REGION_ROWS + rg * RPT + i) * bw + col] = acc[i];
  }
  __syncthreads();
  if (active && kp == 0) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float s = 0.f;
      for (int q = 0; q < ks; ++q)
        s += red[(q * RT_REGION_ROWS + rg * RPT + i) * bw + col];
      acc[i] = s;
    }
  }
  __syncthreads();
}

// One column block [c0, c0 + bw) of an mm step's output on this CTA: walk
// its chunks of the ring, reduce, apply the epilogue and store.  Rows r0 ..
// r0 + RT_REGION_ROWS - 1 of the tile, whose x starts at row r0 of S.xs
// (row stride ldx, or K when ldx is 0).
template <int RPT, bool kSavePre, bool kVec = true>
__device__ __forceinline__ void mm_block(const int* I, const float* fc,
                                         const LaneTable& P, const Cta& c,
                                         const Smem& S, WRing& ring, int c0,
                                         int bw, int nchunks, int kr,
                                         float* pre, int pre_ld, int pre_c0,
                                         int r0 = 0, int ldx = 0) {
  const int N = I[1], K = I[2], n0 = I[6], flags = I[8];
  const int ld = ldx ? ldx : K;
  const float* xs = S.xs + r0 * ld;
  const int ks = split_of(N);
  const int items = (RT_REGION_ROWS / RPT) * ks * bw;
  const int t = threadIdx.x;
  const bool active = t < items;
  const int col = active ? t % bw : 0;
  const int rest = active ? t / bw : 0;
  const int kp = rest % ks, rg = rest / ks;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  if (!ring.on) {  // the whole K from L2
    const float* w = tensor(P, I[3], c.lane) + (long long)I[5] * I[4] + n0 + c0;
    __syncthreads();  // x is gathered
    if (active)
      mm_accumulate<RPT, true, kVec>(xs, ld, w, I[4], 0, K, ks, kp, rg, col,
                                     acc);
  }
  for (int j = 0; ring.on && j < nchunks; ++j) {
    const float* w = ring.wait();
    const int kb = j * kr, ke = K < kb + kr ? K : kb + kr;
    if (active)
      mm_accumulate<RPT, false, kVec>(xs, ld, w, bw, kb, ke, ks, kp, rg, col,
                                      acc);
    ring.release(c, P);
  }
  reduce_partials<RPT>(S.red, ks, bw, active, kp, rg, col, acc);
  if (!active || kp != 0) return;
  const float* bias = I[7] >= 0 ? tensor(P, I[7], c.lane) + n0 : nullptr;
  const float w0 = fc[I[9]];
  const int n = c0 + col;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + rg * RPT + i;
    if (r >= c.rows) break;
    float* o = at(c, P, I + 10, r, n);
    float h = acc[i];
    if (flags & 2) h = *o + h;
    if (flags & 4) {
      if (bias) h += __ldg(bias + n);
      if (flags & 1) {
        if (kSavePre) pre[r * pre_ld + (n - pre_c0)] = h;
        h = sinf(w0 * h);
      }
    }
    *o = h;
  }
}

// mm step: x @ W[k0:k0+K, n0:n0+N] [+ b] [-> sin(w0 .)] on the output
// columns this CTA owns.  x is gathered whole (from every CTA that owns a
// part of it), W's columns come through the ring.  With kSavePre (the
// backward's replay), a sin epilogue also writes its argument h to the
// CTA's pre slot [rows, cw].
template <bool kSavePre = false>
__device__ __forceinline__ void mm_step(const int* I, const float* fc,
                                        const LaneTable& P, const Cta& c,
                                        const Smem& S, WRing& ring,
                                        float* pre = nullptr) {
  const int N = I[1], K = I[2];
  int lo, hi;
  owned(c, I + 10, N, lo, hi);
  const int ncw = hi - lo;
  if (ncw <= 0) {  // no columns here: take the step's one empty chunk
    if (ring.on) {
      ring.wait();
      ring.release(c, P);
    }
    return;
  }
  gather(c, P, I + 15, K, S.xs);  // visible after the ring's barrier
  const int ks = split_of(N);
  const int bw0 = ncw < RT_REGION_THREADS ? ncw : RT_REGION_THREADS;
  const int kr = fwd_block_rows(bw0);
  const int per = cdiv_i(K, kr);
  const int pre_ld = I[10] ? I[12] : 0;  // the out slot's block width
  const int pre_c0 = c.rank * pre_ld - I[13];
  for (int c0 = lo; c0 < hi; c0 += RT_REGION_THREADS) {
    const int bw = hi - c0 < RT_REGION_THREADS ? hi - c0 : RT_REGION_THREADS;
    switch (rows_per_thread(ks, bw)) {
      case 1:
        mm_block<1, kSavePre>(I, fc, P, c, S, ring, c0, bw, per, kr, pre,
                              pre_ld, pre_c0);
        break;
      case 2:
        mm_block<2, kSavePre>(I, fc, P, c, S, ring, c0, bw, per, kr, pre,
                              pre_ld, pre_c0);
        break;
      case 4:
        mm_block<4, kSavePre>(I, fc, P, c, S, ring, c0, bw, per, kr, pre,
                              pre_ld, pre_c0);
        break;
      default:
        mm_block<8, kSavePre>(I, fc, P, c, S, ring, c0, bw, per, kr, pre,
                              pre_ld, pre_c0);
        break;
    }
  }
}

// ---------------------------------------------------------------------------
// host side, shared by rt_region and rt_region_bwd
// ---------------------------------------------------------------------------

// Dynamic shared memory of a column-cluster or region_bwd launch: the
// partial sums, x, the ring (none on region_bwd's one-CTA launch), the
// workspace when it is in shared memory, and the step program with its
// constants when the launch stages them.
static size_t region_smem(int xs_floats, int extra_floats, int ws_floats,
                          bool in_smem, int C, int table_ints, int fc_floats) {
  return sizeof(float) *
         ((size_t)RT_RED_FLOATS + xs_floats + extra_floats +
          (C > 1 ? (size_t)RT_WRING * RT_WSTAGE_FLOATS : 0) +
          (in_smem ? (size_t)ws_floats : 0) +
          (table_ints > 0 ? (size_t)((table_ints + 3) & ~3) + fc_floats : 0));
}

// Shared-memory opt-in above 48 KB and clusters wider than 8, once per
// device and kernel.
template <class Kernel>
static cudaError_t region_attributes(Kernel kernel, bool* opted) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && opted[dev]) return cudaSuccess;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           RT_SMEM_BYTES - (int)attr.sharedSizeBytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  if (dev < 64) opted[dev] = true;
  return cudaSuccess;
}

static void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                           dim3 grid, int C, size_t smem, void* stream,
                           int threads = RT_REGION_THREADS) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}
