// Dense-rectangle fleet sketch update for Hopper (sm_90a).
//
// Replaces the TPU kernel `fleet_update_kernel` / `fleet_update_pallas`
// (src/repro/kernels/sketch_update/fleet.py), the cs/cms oracle layout
// (`layout="dense"`) whose body is `_frag_contrib` -> `block_contrib`.
//
// What it computes: the counters of every fragment of one fleet epoch from
// an (n_frags, p_max) packet rectangle (row f is fragment f's stream,
// value-0 padded) and an (n_frags, 8) int32 parameter table, into an
// (n_frags, n_sub_max, width_max) f32 stack with exact zeros outside each
// fragment's live [:n_sub, :width] block.  As in the reference, the level
// and §4.4 terms are compiled out (cs/cms only); the per-packet hashing is
// sketch_hash.cuh's, shared with the other update kernels.
//
// Design: one packet-parallel pass, as in fleet_ragged.cu.  The grid spans
// (fragment, chunk of 1 024 slots): CTA c owns chunk c % chunks_per_row of
// row c / chunks_per_row, and each of its 256 threads takes 4 slots with
// one 16-byte load each of values, keys and timestamps (p_max is a
// multiple of 4, so a row never splits a load).  A warp whose 128 slots
// are all value-0 padding ends there.  Each live packet is hashed once and
// added into the caller's zeroed output by sketch::add_quad with global
// atomicAdds, reductions (RED) that resolve in L2; adds that hit one
// counter are summed first (with one atomic per packet, a heavy hitter
// serialised its atomics in L2: 34x the uniform-key time on a 2^20-slot
// row on an H100, PERF.md).  So the launch fills the card (§6.1: 20 x
// 32 768 slots give 640 CTAs), every slot is read once per launch whatever
// the widths, and no per-CTA tile is zeroed or written for rows with fewer
// packets than counters.
//
// Exactness: counters are sums of integers, bounded below 2^24 by the
// caller (core/fleet.py _check_input_mass for cs, the output peak check for
// cms), so every partial sum is exact in f32 and no order of the atomics
// can change a bit.
//
// What bounds it on the H100: bytes.  The zeroed output is written once
// (n_frags * n_sub_max * width_max * 4 B), and the rectangle costs 4 B a
// slot (its value) plus 8 B a live packet (key and timestamp).
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "sketch_hash.cuh"

namespace {

constexpr int kThreads = 256;  // kernels/sketch_update/fleet.py CTA_THREADS
constexpr int kSlots = 4;      // packet slots per 16-byte load

__global__ void __launch_bounds__(kThreads)
fleet_dense_kernel(const uint4* __restrict__ keys,
                   const float4* __restrict__ vals,
                   const uint4* __restrict__ ts,
                   const int32_t* __restrict__ params,
                   float* __restrict__ out, long long p_max,
                   int chunks_per_row, int n_sub_max, int width_max,
                   int log2_te, int is_signed) {
  const int f = blockIdx.x / chunks_per_row;
  const long long j = blockIdx.x - static_cast<long long>(f) * chunks_per_row;
  const long long quads_per_row = p_max / kSlots;
  const long long qj = j * kThreads + threadIdx.x;  // quad within the row
  const long long q = f * quads_per_row + qj;
  // Every lane of a warp goes on to add_quad unless the whole warp holds
  // padding (a lane past the row's end holds zeros).
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (qj < quads_per_row) v = vals[q];
  const bool live = v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f;
  if (!__any_sync(0xFFFFFFFFu, live)) return;  // padding
  uint4 k = make_uint4(0u, 0u, 0u, 0u), t = k;
  if (live) {
    k = keys[q];
    t = ts[q];
  }
  const sketch::Row row = sketch::row_from_params(
      params + static_cast<size_t>(f) * sketch::kNParams, log2_te,
      is_signed != 0, false, false);
  float* o = out + static_cast<size_t>(f) * n_sub_max * width_max;
  sketch::add_quad(row, k, t, v, o, width_max);
}

}  // namespace

extern "C" {

// Launch `grid` CTAs on `stream` into `out`, which the caller has zeroed;
// allocates nothing.  The rectangle must be 16-byte aligned and p_max a
// multiple of 4.  Returns cudaGetLastError().
int fleet_dense_launch(const void* keys, const void* vals, const void* ts,
                       const void* params, void* out, long long p_max,
                       int chunks_per_row, int grid, int n_sub_max,
                       int width_max, int log2_te, int is_signed,
                       void* stream) {
  fleet_dense_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(keys), static_cast<const float4*>(vals),
      static_cast<const uint4*>(ts), static_cast<const int32_t*>(params),
      static_cast<float*>(out), p_max, chunks_per_row, n_sub_max, width_max,
      log2_te, is_signed);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
