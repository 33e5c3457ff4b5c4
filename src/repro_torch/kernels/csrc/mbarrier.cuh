// Hopper's asynchronous copies and the shared-memory barriers that track
// them, shared by flash_attention_tc.cu (TMA tensor loads of Q, K, V),
// region.cu (bulk copies of weight chunks, multicast to the CTAs of a
// cluster), the region kernels' cp.async weight ring (region_steps.cuh) and
// fused_chain.cu (cp.async staging of a tile's operands).
//
// A barrier (mbarrier) completes a phase when its pending arrivals reach
// zero and every byte a copy announced (expect_tx) has landed; waiters name
// the phase by its parity.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async: 4 or 16 bytes from global memory to shared memory, completing
// with the thread's cp.async groups (cp.async.commit_group / wait_group)
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy and to the other
// CTAs of the cluster (a cluster barrier follows before any use)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrive on the barrier at bar's offset in CTA `rank` of the cluster
// (release semantics at CTA scope, the default: this thread's reads of the
// stage it releases are done)
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(rank)
      : "memory");
}

// arrive on the barrier at bar's offset in CTA `rank` of the cluster and
// announce `bytes` that a copy will bring to it
__device__ __forceinline__ void mbar_expect_tx_cluster(uint64_t* bar,
                                                       uint32_t rank,
                                                       uint32_t bytes) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.expect_tx.shared::cluster.b64 _, [ra], "
      "%2;\n}\n" ::"r"(smem_u32(bar)),
      "r"(rank), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t addr,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done;
}

// whether the phase of parity `parity` has completed, without waiting:
// try_wait may suspend the thread for a while when it has not
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of parity `parity` has completed.  A phase that has
// not completed after ~2^35 cycles (~17 s) is a schedule bug: trap, so that
// the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// wait for the phase of parity `parity` by polling: a thread that
// try_wait suspends may sleep well past the phase's completion, which a
// ring of short chunks pays on every chunk
__device__ __forceinline__ void mbar_spin(uint64_t* bar, uint32_t parity) {
  if (mbar_test(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_test(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from global memory to dst, completing on bar; with mask != 0, into dst and
// bar at the same offsets in every CTA of the cluster whose bit is set
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint16_t mask) {
  if (mask)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}
