// region: a whole fused region of the gradient pipeline as ONE launch.
//
// Replaces the TPU megakernel repro/kernels/region.py::region_call
// (pallas_call at region.py:277), including its tile_groups column tiling
// (region.py::_eval_group), and, over K weight lanes, region_call_stacked
// (pallas_call at region.py:329).  The program is compiled once per region
// spec and launch design by kernels/region.py into an int32 instruction table
// and a float table that stay on the device, so a launch uploads nothing: it
// passes only the tensor pointers (by value, in the parameter block) and the
// row count.  Lane k of a K-lane launch (grid y) moves every pointer by k x
// its per-lane stride.  Every output element is summed in an order fixed by
// its step's shape (region_steps.cuh), so lane k equals a K = 1 launch on
// lane k's operands bit for bit, whichever design either launch took.
//
// Two designs, picked by shape (kernels/region.py::launch_cluster):
//
// - Column clusters (region_kernel, C = 2..16 CTAs per 8-row tile), when few
//   tiles leave most SMs idle: the main path's 8-row launch takes C = 16.
//   Each CTA owns a column block of every value, [8, ceil(w / C)] in its
//   shared memory, an mm step gathers its whole x from the cluster through
//   distributed shared memory, and each CTA streams its slice W[:, its
//   columns] of every mm through a cp.async ring one chunk ahead.  At 8 rows
//   a launch is bound by latency: 47 dependent steps at order 2, each spread
//   over C SMs and closed by a cluster barrier.
//
// - Row clusters (region_rows_kernel), when the tiles fill the card on their
//   own (the stacked K = 8, R = 8,192 launch: 65,536 rows).  One CTA owns
//   every column of RB = 8, 16 or 32 rows; a cluster of Cr = 2 CTAs (1
//   where a lane has one tile) takes Cr adjacent row tiles of one lane.  Per
//   RB-row tile an mm step [RB, 256] @ [256, 256] does 2 RB 65,536 flops
//   against 256 KB of weights, and a launch at order 2 does 1.04e11 flops:
//   1.56 ms at 67 TFLOP/s, so it is bound by operations once the weights
//   stop costing more than that.
//   Read from L2 by every 8-row tile, the weights alone would move 26 GB
//   per launch, and a thread holding 8 rows x 1 column needs 12 shared-
//   memory wavefronts per 32 FMAs.  So:
//   * each chunk of an mm's weights is copied once from L2, by one bulk copy
//     that rank 0's producer warp issues with .multicast::cluster into the
//     same stage of all Cr CTAs' rings, and stays in shared memory while
//     each CTA runs its RB rows against it: L2 traffic falls by Cr x RB /
//     8.  A stage completes on a full barrier per CTA (the bytes it
//     expects); the producer refills it once every consumer warp of the
//     cluster arrived on rank 0's empty barrier, 2 chunks ahead, across
//     chain steps.  The producer warp joins every step's barriers and does
//     no arithmetic, so the consumers never wait on another CTA's progress
//     except through the stage they need;
//   * a thread holds RB / 4 rows x 4 columns (rows r, r + 4, ... so that the
//     4 rows one warp reads lie in different banks at x's row stride
//     K + 4): per 4 k a warp loads RB / 4 x float4s and 4 weight float4s
//     (one wavefront each) for 4 RB FMAs.  x is read in place: the
//     lowering pads every workspace row to that stride;
//   * chain steps keep 4 elements a thread in flight (a CTA holds every
//     column of its rows, so 16-32 elements a thread a step);
//   * mm steps with narrow outputs (N <= 128, split_of(N) partial chains),
//     or rows that are not whole 16-byte granules, keep the one-CTA
//     arithmetic of region_steps.cuh (W from L2) over 8 rows at a time;
//     their weights are a few KB.
//   Each CTA walks every step and every chunk of the ring, a CTA past the
//   last row included, so every barrier of the cluster sees all its CTAs.
//   The workspace lives in shared memory ([RB, padded w] per value), two
//   CTAs per SM where it is small enough (order 1), else one; or, when it
//   does not fit beside two stages, in a per-CTA slice of a global buffer
//   the wrapper allocates.
#include "region_steps.cuh"

// ---------------------------------------------------------------------------
// the column-cluster launch
// ---------------------------------------------------------------------------

// grid (tiles x C, K): cluster blockIdx.x / C walks the step program on the
// RT_REGION_ROWS rows of its tile, blockIdx.y is the lane; R rows per lane.
__global__ void __launch_bounds__(RT_REGION_THREADS, 1)
    region_kernel(const int* __restrict__ gprog,
                  const float* __restrict__ gfc, int n_instr, LaneTable P,
                  long long R, int ws_floats, int xs_floats, int table_ints,
                  int fc_floats, float* gws) {
  extern __shared__ __align__(16) float smem[];
  Cta c;
  c.rank = (int)cg::this_cluster().block_rank();
  c.csize = (int)cg::this_cluster().num_blocks();
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
  ring.on = true;
  ring.stage = S.xs + xs_floats;
  float* lws = ring.stage + RT_WRING * RT_WSTAGE_FLOATS;
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

// ---------------------------------------------------------------------------
// the row-cluster launch
// ---------------------------------------------------------------------------

// columns of one mm column block: RT_ROW_GROUPS threads across rows, the
// rest across columns, RT_COL_TILE columns each
#define RT_ROWS_BLOCK (RT_ROWS_CONSUMERS / RT_ROW_GROUPS * RT_COL_TILE)
// elements of a chain step each thread keeps in flight
#define RT_CHAIN_ILP 4
// threads of a row-cluster CTA: the consumers and one producer warp
#define RT_ROWS_THREADS (RT_ROWS_CONSUMERS + 32)

// x's row stride in xs for an mm of depth K: K + 4 rounded so that the
// RT_ROW_GROUPS rows a warp reads at once start in different banks (K when
// K is not a multiple of 4: x is then read a float at a time);
// kernels/region.py::rows_ldx mirrors it
__device__ __forceinline__ int rows_ldx(int K) {
  return (K & 3) ? K : ((K + 7) & ~7) + 4;
}

// A row-cluster launch: rows per CTA, CTAs per cluster, the shared-memory
// layout (floats: partial sums, x, the ring's RT_ROWS_STAGES stages, then
// the workspace when it is in shared memory) and where the chunk table
// starts in the program (ints) and how many chunks it lists.
struct RowsLayout {
  int rows, row_cluster, red_floats, xs_floats, stage_floats;
  int chunk_off, n_chunks;
};

// The weight ring of a row cluster.  The wrapper lists its chunks in program
// order (RT_CHUNK_INTS ints each: pointer-table index, element offset from
// the lane's tensor, rows, columns, W's row stride): rows [k, k + kr) of one
// <= RT_ROWS_BLOCK-column block of an mm's W slice, stored [kr][columns] in
// stage j % S of every CTA (S = RT_ROWS_STAGES).  A CTA runs RT_ROWS_CONSUMERS
// consumer threads and one producer warp, which takes part in every step's
// barriers but in a ring step only issues copies: on rank 0, its lane 0
// waits until every consumer warp of the cluster has released chunk j - S
// (the empty barrier), arms each CTA's full barrier with the bytes chunk j
// brings and issues one multicast bulk copy (or one per row of a strided
// slice), up to S chunks past the step's last.  Each consumer warp waits
// for a chunk's bytes and releases it on its own, so warps drift apart by
// up to S chunks instead of meeting at a CTA barrier.
struct MRing {
  static constexpr int S = RT_ROWS_STAGES;
  float* stage;
  uint64_t* full;   // S barriers: rank 0's arming arrival + the bytes
  uint64_t* empty;  // S barriers on rank 0: one arrival per consumer warp
  int stage_floats, rank, csize;
  const int* chunks;
  int n_chunks;
  long long lane;
  int done;         // chunks of the ring steps before this one
  int pushed;       // the producer: chunks issued,
  int ps;           // the stage of the next one
  uint32_t pphase;  // and the parity of that stage's phase
  int cs;           // a consumer's next chunk: its stage
  uint32_t phase;   // and the parity of that stage's phase

  // rows of W per chunk of a ring step with N output columns (a multiple
  // of 4, so x's float4 loads stay aligned); kernels/region.py lists the
  // chunks by the same rule
  __device__ __forceinline__ int chunk_rows(int N) const {
    const int bw0 = N < RT_ROWS_BLOCK ? N : RT_ROWS_BLOCK;
    return (stage_floats / bw0) & ~3;
  }

  // the producer warp (rank 0): issue the chunks before `upto`; per chunk
  // lane q < Cr arms CTA q's full barrier and lane 0 issues the copy (a
  // strided slice: lane r the rows r, r + 32, ...)
  __device__ void produce(const LaneTable& P, int upto) {
    const int lane_id = threadIdx.x & 31;
    for (; pushed < upto && pushed < n_chunks; ++pushed) {
      const int* e = chunks + (long long)pushed * RT_CHUNK_INTS;
      const int rows = e[2], cols = e[3], ldw = e[4];
      const int s = ps;
      if (pushed >= S) mbar_spin(&empty[s], pphase ^ 1);
      if (++ps == S) {
        ps = 0;
        pphase ^= 1;
      }
      const uint32_t bytes = 4u * (uint32_t)(rows * cols);
      if (lane_id == 0)
        mbar_expect_tx(&full[s], bytes);
      else if (lane_id < csize)
        mbar_expect_tx_cluster(&full[s], lane_id, bytes);
      const float* src = tensor(P, e[0], lane) + e[1];
      float* dst = stage + (long long)s * stage_floats;
      const uint16_t mask =
          csize > 1 ? (uint16_t)((1u << csize) - 1u) : (uint16_t)0;
      if (ldw == cols) {
        if (lane_id == 0) bulk_load(dst, src, bytes, &full[s], mask);
      } else {
        for (int r = lane_id; r < rows; r += 32)
          bulk_load(dst + r * cols, src + (long long)r * ldw,
                    4u * (uint32_t)cols, &full[s], mask);
      }
      __syncwarp();
    }
  }

  // a consumer: the next chunk of the sequence, once its bytes have landed
  __device__ __forceinline__ const float* wait() {
    mbar_spin(&full[cs], phase);
    return stage + (long long)cs * stage_floats;
  }

  // a consumer warp is done with the current chunk: arrive on rank 0's
  // empty barrier
  __device__ __forceinline__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      if (rank == 0)
        mbar_arrive(&empty[cs]);
      else
        mbar_arrive_cluster(&empty[cs], 0);
    }
    if (++cs == S) {
      cs = 0;
      phase ^= 1;
    }
  }
};

// x [RB, K] of a view into xs (row stride ldx), zeros past the tile's rows.
// This CTA owns every column, so a workspace value is in its own workspace.
template <int RB>
__device__ __forceinline__ void gather_rows(const Cta& c, const LaneTable& P,
                                            const int* v, int K, int ldx,
                                            float* xs) {
  for (int i = threadIdx.x; i < RB * K; i += blockDim.x) {
    const int r = i / K, k = i - r * K;
    xs[r * ldx + k] = r < c.rows ? *at(c, P, v, r, k) : 0.f;
  }
}

// acc[i][u] (row rg + RT_ROW_GROUPS i, column u of the thread's tile) +=
// x[row, k] w[k, u] for k in [kb, ke), in increasing k; w points at the
// thread's first column of the chunk's row kb (row stride bw).  kTwo: two
// rounds of 4 k in flight (the registers of one round twice over).
template <int RT, bool kTwo>
__device__ __forceinline__ void rows_accumulate(
    const float* xs, int ldx, const float* w, int bw, int kb, int ke, int rg,
    float (&acc)[RT][RT_COL_TILE]) {
  const float* x0 = xs + rg * ldx;
  const int xstep = RT_ROW_GROUPS * ldx;
  auto round4 = [&](int k) {
    const float* wk = w + (k - kb) * bw;
    float4 wv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      wv[q] = *reinterpret_cast<const float4*>(wk + q * bw);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float4 x4 = *reinterpret_cast<const float4*>(x0 + i * xstep + k);
      const float xq[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[i][0] = fmaf(xq[q], wv[q].x, acc[i][0]);
        acc[i][1] = fmaf(xq[q], wv[q].y, acc[i][1]);
        acc[i][2] = fmaf(xq[q], wv[q].z, acc[i][2]);
        acc[i][3] = fmaf(xq[q], wv[q].w, acc[i][3]);
      }
    }
  };
  int k = kb;
  if ((ldx & 3) == 0) {
    if (kTwo) {
#pragma unroll 2
      for (; k + 4 <= ke; k += 4) round4(k);
    } else {
#pragma unroll 1
      for (; k + 4 <= ke; k += 4) round4(k);
    }
  }
  for (; k < ke; ++k) {
    const float4 wv = *reinterpret_cast<const float4*>(w + (k - kb) * bw);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float xv = x0[i * xstep + k];
      acc[i][0] = fmaf(xv, wv.x, acc[i][0]);
      acc[i][1] = fmaf(xv, wv.y, acc[i][1]);
      acc[i][2] = fmaf(xv, wv.z, acc[i][2]);
      acc[i][3] = fmaf(xv, wv.w, acc[i][3]);
    }
  }
}

// mm step of a row cluster: x @ W[k0:k0+K, n0:n0+N] [+ b] [-> sin(w0 .)] on
// the CTA's RB rows, every column.
template <int RB, bool kTwo>
__device__ __forceinline__ void rows_mm_step(const int* I, const float* fc,
                                             const LaneTable& P, const Cta& c,
                                             const Smem& S, MRing& ring) {
  constexpr int RT = RB / RT_ROW_GROUPS;
  const int N = I[1], K = I[2], flags = I[8];
  // x in place in its workspace slot (the lowering pads slot rows to
  // rows_ldx), else copied into xs
  const int* v = I + 15;
  Smem X = S;
  int ldx = v[2];
  if (v[0] && v[4] == 1 && ((v[2] | v[3] | K) & 3) == 0) {
    X.xs = c.ws + v[1] + v[3];
  } else {
    ldx = rows_ldx(K);
    gather_rows<RB>(c, P, v, K, ldx, S.xs);
    __syncthreads();
  }
  if (!I[20]) {
    // narrow outputs: the one-CTA arithmetic, 8 rows at a time, W from L2
    // (a fma chain a float at a time: the same order, fewer registers)
    WRing l2;
    l2.on = false;
    const int ks = split_of(N);
    for (int c0 = 0; c0 < N; c0 += RT_REGION_THREADS) {
      const int bw = N - c0 < RT_REGION_THREADS ? N - c0 : RT_REGION_THREADS;
      for (int r0 = 0; r0 < c.rows; r0 += RT_REGION_ROWS) {
        switch (rows_per_thread(ks, bw)) {
          case 1:
            mm_block<1, false, false>(I, fc, P, c, X, l2, c0, bw, 0, 0,
                                      nullptr, 0, 0, r0, ldx);
            break;
          case 2:
            mm_block<2, false, false>(I, fc, P, c, X, l2, c0, bw, 0, 0,
                                      nullptr, 0, 0, r0, ldx);
            break;
          case 4:
            mm_block<4, false, false>(I, fc, P, c, X, l2, c0, bw, 0, 0,
                                      nullptr, 0, 0, r0, ldx);
            break;
          default:
            mm_block<8, false, false>(I, fc, P, c, X, l2, c0, bw, 0, 0,
                                      nullptr, 0, 0, r0, ldx);
            break;
        }
      }
    }
    return;
  }
  const int kr = ring.chunk_rows(N), per = cdiv_i(K, kr);
  const int n_step = cdiv_i(N, RT_ROWS_BLOCK) * per;
  const int t = threadIdx.x;
  if (t >= RT_ROWS_CONSUMERS) {  // the producer warp
    if (ring.rank == 0)
      ring.produce(P, ring.done + n_step + ring.S);
    ring.done += n_step;
    return;
  }
  ring.done += n_step;
  const int rg = t % RT_ROW_GROUPS, col = RT_COL_TILE * (t / RT_ROW_GROUPS);
  const float* bias = I[7] >= 0 ? tensor(P, I[7], c.lane) + I[6] : nullptr;
  const float w0 = fc[I[9]];
  const Flat out = flat_view(c, P, I + 10, 0, N);  // every column here
  for (int c0 = 0; c0 < N; c0 += RT_ROWS_BLOCK) {
    const int bw = N - c0 < RT_ROWS_BLOCK ? N - c0 : RT_ROWS_BLOCK;
    const bool active = c.rows > 0 && col < bw;
    float acc[RT][RT_COL_TILE];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int u = 0; u < RT_COL_TILE; ++u) acc[i][u] = 0.f;
    for (int j = 0; j < per; ++j) {
      const float* w = ring.wait();
      const int kb = j * kr, ke = K < kb + kr ? K : kb + kr;
      if (active)
        rows_accumulate<RT, kTwo>(X.xs, ldx, w + col, bw, kb, ke, rg, acc);
      ring.release();
    }
    if (!active) continue;
    float b[RT_COL_TILE];
#pragma unroll
    for (int u = 0; u < RT_COL_TILE; ++u)
      b[u] = bias && (flags & 4) ? __ldg(bias + c0 + col + u) : 0.f;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = rg + RT_ROW_GROUPS * i;
      if (r >= c.rows) continue;
      float* o = const_cast<float*>(out.base) + r * out.rs +
                 (c0 + col) * out.cs;
#pragma unroll
      for (int u = 0; u < RT_COL_TILE; ++u) {
        float h = acc[i][u];
        if (flags & 2) h = o[u * out.cs] + h;
        if (flags & 4) {
          if (bias) h += b[u];
          if (flags & 1) h = sinf(w0 * h);
        }
        o[u * out.cs] = h;
      }
    }
  }
}

// grid (CTAs per lane, K), clusters of Cr CTAs along x: CTA x walks the step
// program on rows [x RB, (x + 1) RB) of lane blockIdx.y (none past R).
// kMinBlocks CTAs of RT_ROWS_THREADS threads per SM, as many as the
// launch's shared memory allows (rows_entry), which caps the registers: a
// scheduler of the SM holds 3 (or 5) of the 9 (or 18) warps, so 168 (or
// 96) registers a thread.
template <int RB, int kMinBlocks>
__global__ void __launch_bounds__(RT_ROWS_THREADS, kMinBlocks)
    region_rows_kernel(const int* __restrict__ prog,
                       const float* __restrict__ fc, int n_instr, LaneTable P,
                       long long R, int ws_floats, RowsLayout L, float* gws) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t s_full[MRing::S];
  __shared__ __align__(8) uint64_t s_empty[MRing::S];
  cg::cluster_group cluster = cg::this_cluster();
  Cta c;
  c.rank = 0;  // column ownership: one CTA owns every column
  c.csize = 1;
  c.lane = blockIdx.y;
  c.row0 = (long long)blockIdx.x * RB;
  const long long left = R - c.row0;
  c.rows = left <= 0 ? 0 : left < RB ? (int)left : RB;
  c.ws_floats = ws_floats;
  Smem S;
  S.red = smem;
  S.xs = smem + L.red_floats;
  S.ds = nullptr;
  MRing ring;
  ring.stage = S.xs + L.xs_floats;
  ring.full = s_full;
  ring.empty = s_empty;
  ring.stage_floats = L.stage_floats;
  ring.rank = (int)cluster.block_rank();
  ring.csize = (int)cluster.num_blocks();
  ring.chunks = prog + L.chunk_off;
  ring.n_chunks = L.n_chunks;
  ring.lane = c.lane;
  ring.done = ring.pushed = ring.ps = ring.cs = 0;
  ring.pphase = ring.phase = 0;
  if (gws) {
    c.ws = gws + ((long long)c.lane * gridDim.x + blockIdx.x) * ws_floats;
    c.gws = c.ws;
  } else {
    c.ws = ring.stage + (long long)MRing::S * L.stage_floats;
    c.gws = nullptr;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < MRing::S; ++s) {
      mbar_init(&s_full[s], 1);
      mbar_init(&s_empty[s], ring.csize * (RT_ROWS_CONSUMERS / 32));
    }
    mbar_fence_init();
  }
  prefetch_l1(prog, (long long)n_instr * RT_INSTR_INTS * sizeof(int));
  cluster.sync();  // every CTA's barriers exist before a copy or an arrival
  if (ring.rank == 0 && threadIdx.x >= RT_ROWS_CONSUMERS)
    ring.produce(P, ring.S);
  for (int s = 0; s < n_instr; ++s) {
    const int* I = prog + (long long)s * RT_INSTR_INTS;
    if (I[0] == 0)
      chain_step<RT_CHAIN_ILP>(I, prog, fc, P, c);
    else
      // two rounds of FMAs in flight where the registers allow
      rows_mm_step<RB, RB <= 16 && kMinBlocks == 1>(I, fc, P, c, S, ring);
    __syncthreads();
  }
  cluster.sync();  // no CTA leaves while another may arrive on its barriers
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef void (*RowsEntry)(const int*, const float*, int, LaneTable, long long,
                          int, RowsLayout, float*);

static bool g_cluster_opted[64] = {false};
static bool g_rows_opted[5][64] = {{false}};

// Whether two CTAs of a row-cluster launch with `smem` bytes of dynamic
// shared memory fit on one SM (the runtime reserves 1 KB per CTA beside
// its static arrays); kernels/region.py::rows_per_sm mirrors it.
static bool rows_two_per_sm(size_t smem) {
  return 2 * (smem + 1024 + RT_SMEM_STATIC) <= RT_SM_SMEM_BYTES;
}

// The row-cluster instantiation for RB-row tiles at `smem` bytes of dynamic
// shared memory (its index in g_rows_opted in *slot): two CTAs per SM where
// their shared memory allows it (8 or 16 rows), else one.  Null for an RB
// not built.
static RowsEntry rows_entry(int rows, size_t smem, int* slot) {
  const bool two = rows_two_per_sm(smem);
  switch (rows) {
    case 8:
      *slot = two ? 0 : 1;
      return two ? region_rows_kernel<8, 2> : region_rows_kernel<8, 1>;
    case 16:
      *slot = two ? 2 : 3;
      return two ? region_rows_kernel<16, 2> : region_rows_kernel<16, 1>;
    case 32:
      *slot = 4;
      return region_rows_kernel<32, 1>;
    default:
      return nullptr;
  }
}

static size_t rows_smem(const RowsLayout& L, int ws_floats, bool in_smem) {
  return sizeof(float) * ((size_t)L.red_floats + L.xs_floats +
                          (size_t)RT_ROWS_STAGES * L.stage_floats +
                          (in_smem ? (size_t)ws_floats : 0));
}

// RT_DESIGN_INTS ints in RowsLayout's order, checked
static bool rows_layout(const int* d, int table_ints, RowsLayout* L) {
  if (!d) return false;
  *L = RowsLayout{d[0], d[1], d[2], d[3], d[4], d[5], d[6]};
  return L->row_cluster >= 1 && L->row_cluster <= RT_ROW_CLUSTER &&
         L->stage_floats >= 4 * RT_ROWS_BLOCK && !(L->stage_floats & 3) &&
         L->red_floats >= 0 && !(L->red_floats & 3) && L->chunk_off >= 0 &&
         L->n_chunks >= 0 && table_ints == 0;
}

// K lanes of R rows each.  strides[i]: elements between lane k and lane k + 1
// of tensor i (a single-lane launch passes K = 1 and no strides).  C > 1:
// column clusters of C CTAs per 8-row tile; C = 1: row clusters laid out by
// `design` (RowsLayout's RT_DESIGN_INTS ints).  A cluster the card cannot
// schedule is an error returned to the caller, never a quiet other launch.
extern "C" int rt_region(const int* prog, const float* fc, int n_instr,
                         int n_ptrs, const long long* ptrs,
                         const long long* strides, int K, long long R,
                         int ws_floats, int xs_floats, int table_ints,
                         int fc_floats, int C, const int* design, float* gws,
                         void* stream) {
  if (n_ptrs < 0 || n_ptrs > RT_MAX_PTRS || ws_floats < 0 || xs_floats < 0 ||
      (xs_floats & 3) || K < 0 || K > RT_MAX_LANES || C < 1 ||
      C > RT_MAX_CLUSTER || table_ints < 0 || fc_floats < 0)
    return (int)cudaErrorInvalidValue;
  RowsLayout L{};
  if (C == 1 && (!rows_layout(design, table_ints, &L) || L.xs_floats != xs_floats))
    return (int)cudaErrorInvalidValue;
  LaneTable P;
  for (int i = 0; i < RT_MAX_PTRS; ++i) {
    P.p[i] = i < n_ptrs ? reinterpret_cast<const float*>(ptrs[i]) : nullptr;
    P.stride[i] = i < n_ptrs && strides ? strides[i] : 0;
  }
  if (R <= 0 || K == 0) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e;
  if (C > 1) {
    const long long tiles = (R + RT_REGION_ROWS - 1) / RT_REGION_ROWS;
    const size_t smem = region_smem(xs_floats, 0, ws_floats, gws == nullptr,
                                    C, table_ints, fc_floats);
    e = region_attributes(region_kernel, g_cluster_opted);
    if (e != cudaSuccess) return (int)e;
    cluster_config(&cfg, &attr, dim3((unsigned)(tiles * C), (unsigned)K), C,
                   smem, stream);
    e = cudaLaunchKernelEx(&cfg, region_kernel, prog, fc, n_instr, P, R,
                           ws_floats, xs_floats, table_ints, fc_floats, gws);
  } else {
    const size_t smem = rows_smem(L, ws_floats, gws == nullptr);
    int slot = 0;
    const RowsEntry kernel = rows_entry(L.rows, smem, &slot);
    if (!kernel) return (int)cudaErrorInvalidValue;
    e = region_attributes(kernel, g_rows_opted[slot]);
    if (e != cudaSuccess) return (int)e;
    const long long tiles = (R + L.rows - 1) / L.rows;
    const long long ctas =
        (tiles + L.row_cluster - 1) / L.row_cluster * L.row_cluster;
    cluster_config(&cfg, &attr, dim3((unsigned)ctas, (unsigned)K),
                   L.row_cluster, smem, stream, RT_ROWS_THREADS);
    e = cudaLaunchKernelEx(&cfg, kernel, prog, fc, n_instr, P, R, ws_floats,
                           L, gws);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of a launch the card holds at once
// (cudaOccupancyMaxActiveClusters) with `smem` bytes of dynamic shared memory
// per CTA: column clusters of C > 1 CTAs, or (C = 1) row clusters of
// row_cluster CTAs of `rows` rows; a negative cudaError_t on failure.
extern "C" int rt_region_max_clusters(int C, int rows, int row_cluster,
                                      long long smem) {
  if (C < 1 || C > RT_MAX_CLUSTER || smem < 0 || row_cluster < 1 ||
      row_cluster > RT_ROW_CLUSTER)
    return -(int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int n = 0;
  cudaError_t e;
  if (C > 1) {
    e = region_attributes(region_kernel, g_cluster_opted);
    if (e != cudaSuccess) return -(int)e;
    cluster_config(&cfg, &attr, dim3((unsigned)C), C, (size_t)smem, nullptr);
    e = cudaOccupancyMaxActiveClusters(&n, region_kernel, &cfg);
  } else {
    int slot = 0;
    const RowsEntry kernel = rows_entry(rows, (size_t)smem, &slot);
    if (!kernel) return -(int)cudaErrorInvalidValue;
    e = region_attributes(kernel, g_rows_opted[slot]);
    if (e != cudaSuccess) return -(int)e;
    cluster_config(&cfg, &attr, dim3((unsigned)row_cluster), row_cluster,
                   (size_t)smem, nullptr, RT_ROWS_THREADS);
    e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  }
  return e == cudaSuccess ? n : -(int)e;
}
