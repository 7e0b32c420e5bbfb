// Ragged CSR fleet sketch update for Hopper (sm_90a).
//
// Replaces the TPU kernel `fleet_ragged_kernel` / `fleet_update_ragged_pallas`
// (src/repro/kernels/sketch_update/fleet.py), whose body is
// `_frag_contrib` -> `block_contrib` (src/repro/kernels/sketch_update/kernel.py).
//
// What it computes: the subepoch-record counters of every param row of a
// fleet epoch or window.  Rows are (epoch, fragment[, UnivMon level])
// tuples; stream block b (blk packet slots) belongs to packet row
// block_frag[b], and packet row pr feeds the n_levels virtual rows
// pr * n_levels + l.  The per-packet hashing and §4.1 / §4.4 / UnivMon mask
// are shared with the other update kernels (sketch_hash.cuh).
//
// Design: one packet-parallel pass.  The grid spans the CSR stream: CTA c
// walks stream blocks [c * blocks_per_cta, (c + 1) * blocks_per_cta), and
// each thread takes 4 slots at a time with one 16-byte load each of values,
// keys and timestamps (neighbouring threads on neighbouring addresses; a
// block of blk slots, blk a multiple of 4, never splits a load).  It reads
// its packet row from block_frag itself, as the TPU kernel does through
// scalar prefetch.  A warp whose 128 slots are all value-0 padding ends
// there.  Each live packet is hashed once for each virtual row it feeds
// (UnivMon: the level test exits first) and added into the caller's zeroed
// output by sketch::add_quad with global atomicAdds, reductions (RED) that
// resolve in L2.  Adds that hit one counter are summed first, within the
// thread and among warp lanes whose counter a neighbouring lane also holds:
// with one atomic per packet, a 2^20-packet row with one key on half its
// packets took 21x the time of a row of uniform keys on an H100, as L2
// serialises same-address atomics (PERF.md).  So
//   * the launch fills the card whatever its row count: an epoch's stream
//     (~290 000 packets in ~1 150 blocks) gives ~290 CTAs, and a launch of
//     one or two rows spreads over the SMs as well;
//   * every packet is read once per launch, whatever the row's width;
//   * no per-CTA tile is zeroed or written: a row has fewer packets
//     (~15 000) than counters (up to 123 974), and an epoch's output
//     (~9.4 MB for cs at n = 1) fits the 50 MB L2 where the atomics land.
//
// Exactness: counters are sums of integers.  For cs and um the caller
// bounds each fragment's |value| mass below 2^24 (core/fleet.py
// _check_input_mass); for cms the output peak check bounds every counter.
// So every partial sum is exact in f32, and no order of the atomics can
// change a bit.
//
// What bounds it on the H100: bytes.  The zeroed output is written once
// (rows * n_sub_max * width_max * 4 B), and the stream costs 4 B a slot
// (its value) plus 8 B a live packet (key and timestamp).
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "sketch_hash.cuh"

namespace {

constexpr int kThreads = 256;  // kernels/sketch_update/fleet.py CTA_THREADS
constexpr int kSlots = 4;      // packet slots per 16-byte load

__global__ void __launch_bounds__(kThreads)
fleet_ragged_kernel(const uint4* __restrict__ keys,
                    const float4* __restrict__ vals,
                    const uint4* __restrict__ ts,
                    const int32_t* __restrict__ params,
                    const int32_t* __restrict__ block_frag,
                    float* __restrict__ out, long long n_blocks,
                    int blocks_per_cta, int blk, int n_levels, int n_sub_max,
                    int width_max, int log2_te, int is_signed,
                    int with_levels, int with_mit) {
  const long long quads_per_blk = blk / kSlots;
  const long long b0 = static_cast<long long>(blockIdx.x) * blocks_per_cta;
  const long long b1 = min(b0 + blocks_per_cta, n_blocks);
  const size_t slab = static_cast<size_t>(n_sub_max) * width_max;
  // The CTA walks its range in steps of one quad per thread; every lane
  // takes every step (a lane past the end holds zeros), so the warp stays
  // converged for add_quad.
  const long long q0 = b0 * quads_per_blk, q1 = b1 * quads_per_blk;
  for (long long base = q0; base < q1; base += kThreads) {
    const long long q = base + threadIdx.x;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q < q1) v = vals[q];
    const bool live = v.x != 0.0f || v.y != 0.0f || v.z != 0.0f ||
                      v.w != 0.0f;
    if (!__any_sync(0xFFFFFFFFu, live)) continue;  // blk / bucket padding
    uint4 k = make_uint4(0u, 0u, 0u, 0u), t = k;
    int pr = 0;
    if (live) {
      k = keys[q];
      t = ts[q];
      pr = block_frag[q / quads_per_blk];
    }
    for (int l = 0; l < n_levels; ++l) {
      const size_t r = static_cast<size_t>(pr) * n_levels + l;
      const sketch::Row row = sketch::row_from_params(
          params + r * sketch::kNParams, log2_te, is_signed != 0,
          with_levels != 0, with_mit != 0);
      float* o = out + r * slab;
      sketch::add_quad(row, k, t, v, o, width_max);
    }
  }
}

}  // namespace

extern "C" {

// Launch `grid` CTAs on `stream` into `out`, which the caller has zeroed;
// allocates nothing.  The three streams must be 16-byte aligned.  Returns
// cudaGetLastError().
int fleet_ragged_launch(const void* keys, const void* vals, const void* ts,
                        const void* params, const void* block_frag, void* out,
                        long long n_blocks, int blocks_per_cta, int grid,
                        int blk, int n_levels, int n_sub_max, int width_max,
                        int log2_te, int is_signed, int with_levels,
                        int with_mit, void* stream) {
  fleet_ragged_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(keys), static_cast<const float4*>(vals),
      static_cast<const uint4*>(ts), static_cast<const int32_t*>(params),
      static_cast<const int32_t*>(block_frag), static_cast<float*>(out),
      n_blocks, blocks_per_cta, blk, n_levels, n_sub_max, width_max, log2_te,
      is_signed, with_levels, with_mit);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
