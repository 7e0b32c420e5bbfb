// Single-fragment sketch update for Hopper (sm_90a).
//
// Replaces the TPU kernel `sketch_update_kernel` / `sketch_update_pallas`
// (src/repro/kernels/sketch_update/kernel.py), whose body is
// `block_contrib`.
//
// What it computes: the (n_sub, width) subepoch-record counters of one
// fragment epoch, with the seeds, level and §4.4 flag passed as arguments
// (the fleet kernels read them from a parameter table).  Unlike the dense
// fleet kernel it keeps the UnivMon level and §4.4 terms, since it serves
// level and mitigation rows in fleet_update_loop; the level test is
// locate's first, cheap exit.  The per-packet hashing and mask are
// sketch_hash.cuh's, shared with the fleet kernels.
//
// Design: one packet-parallel pass, as in fleet_ragged.cu and
// fleet_dense.cu.  The host builds one sketch::Row from the arguments and
// passes it by value (no parameter table is copied to the device).  The
// grid is 1-D over the packet axis (kernels/sketch_update/ops.py
// single_geometry): thread i of CTA c takes slots [4q, 4q + 4) with
// q = c * blockDim.x + i, by one 16-byte load each of values, keys and
// timestamps (the wrapper pads the stream with value-0 packets to a
// multiple of 4 and hands 16-byte aligned buffers).  The three loads are
// issued together, so a thread waits for one load's latency, not for the
// values and then the keys: on the sampled §6.1 cs epoch's 20 launches
// (H100, CUDA graph) this takes 0.1188 ms against 0.1205 for loading keys
// and timestamps only for live lanes after the values, as fleet_dense.cu
// does, in both turns of one A/B (PERF.md).  A warp whose 128 slots are
// all value-0 padding then ends.  Each live packet is hashed
// once and added by sketch::add_quad (adds to one counter summed within
// the thread and among warp lanes that share it with a neighbour) with
// global atomicAdds into the output, which the launch function zeroes
// with cudaMemsetAsync on the same stream.  So every packet is read once
// whatever the width, and no per-CTA tile is zeroed or scanned: a row has
// fewer packets (~15 000 at §6.1) than counters (up to 123 974), and its
// output (at most ~1 MB there) sits in the 50 MB L2, where the atomics
// resolve.
//
// Exactness: counters are sums of integers below 2^24 (the wrapper's
// output peak check, ops._guard_peak, and on the fleet paths
// core/fleet.py _check_input_mass), so every partial sum is exact in f32
// and no order of the atomics can change a bit.  add_quad groups only
// integer adds below 2^24; a fractional value on a shared counter still
// takes its own atomic, as the plain version adds it.
//
// What bounds it on the H100: bytes.  The output (n_sub * width * 4 B) is
// written once, and the stream costs 4 B a slot (its value) plus 8 B a
// live packet (key and timestamp; the kernel also reads those of the
// padding slots of warps that hold a live packet).  Launched once per
// fragment, as the loop baseline does, a launch's fixed cost (its memset
// and the launch gap) exceeds that bound by far.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "sketch_hash.cuh"

namespace {

constexpr int kThreads = 64;  // kernels/sketch_update/ops.py CTA_THREADS

__global__ void __launch_bounds__(kThreads)
sketch_update_kernel(const uint4* __restrict__ keys,
                     const float4* __restrict__ vals,
                     const uint4* __restrict__ ts, float* __restrict__ out,
                     long long n_quads, sketch::Row row) {
  const long long q =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // Every lane of a warp goes on to add_quad unless the whole warp holds
  // padding (a lane past the stream's end holds zeros, and add_quad skips
  // value-0 slots).
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  uint4 k = make_uint4(0u, 0u, 0u, 0u), t = k;
  if (q < n_quads) {
    v = vals[q];
    k = keys[q];
    t = ts[q];
  }
  const bool live = v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f;
  if (!__any_sync(0xFFFFFFFFu, live)) return;  // padding
  sketch::add_quad(row, k, t, v, out, row.width);
}

}  // namespace

extern "C" {

// Zero `out`, an (n_sub, width) f32 buffer, and launch `grid` CTAs over
// the stream's n_quads 4-packet slots, all on `stream`; allocates nothing.
// keys, vals and ts must be 16-byte aligned.  Returns the first CUDA
// error, or cudaGetLastError().
int sketch_update_launch(const void* keys, const void* vals, const void* ts,
                         void* out, long long n_quads, int grid,
                         int width, int n_sub, int log2_n_sub, int log2_te,
                         int col_seed, int sign_seed, int sub_seed,
                         int level, int mitigation, int is_signed,
                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(n_sub) * width * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  sketch::Row row;
  row.col_seed = static_cast<uint32_t>(col_seed);
  row.sign_seed = static_cast<uint32_t>(sign_seed);
  row.sub_seed = static_cast<uint32_t>(sub_seed);
  row.width = static_cast<uint32_t>(width);
  row.n_mask = static_cast<uint32_t>(n_sub) - 1u;
  row.shift = static_cast<uint32_t>(log2_te - log2_n_sub);
  row.level = level;
  row.with_levels = level != 0;
  row.mit = mitigation != 0;
  row.is_signed = is_signed != 0;
  sketch_update_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const uint4*>(keys), static_cast<const float4*>(vals),
      static_cast<const uint4*>(ts), static_cast<float*>(out), n_quads, row);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
