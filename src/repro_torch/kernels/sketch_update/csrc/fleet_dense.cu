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
// Design (simple and right first): one CTA per (fragment, width block of
// w_blk columns), with the fleet's n_sub_max x w_blk f32 tile in dynamic
// shared memory (the reference sizes every fragment's tile by n_sub_max
// too).  The tile is zeroed, updated with shared-memory atomicAdd over row
// f, and written out once, zeros included.  Value-0 padding is skipped, and
// width blocks at or past width[f] skip the packets and write zeros (the
// reference's dead-work skip).  Counters are integer sums below 2^24, so
// the atomics' order cannot change a bit.
//
// What bounds it on the H100: memory.  Each CTA reads row f (12 B per
// packet slot, padding included) once per width block, and the launch
// writes n_frags * n_sub_max * width_max * 4 B.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "sketch_hash.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
fleet_dense_kernel(const uint32_t* __restrict__ keys,
                   const float* __restrict__ vals,
                   const uint32_t* __restrict__ ts,
                   const int32_t* __restrict__ params,
                   float* __restrict__ out, long long p_max, int n_sub_max,
                   int width_max, int w_blk, int log2_te, int is_signed) {
  extern __shared__ float tile[];
  const int f = blockIdx.x;
  const uint32_t c0 = static_cast<uint32_t>(blockIdx.y) * w_blk;
  const sketch::Row row = sketch::row_from_params(
      params + static_cast<size_t>(f) * sketch::kNParams, log2_te,
      is_signed != 0, false, false);

  const int tile_n = n_sub_max * w_blk;
  for (int i = threadIdx.x; i < tile_n; i += kThreads) tile[i] = 0.0f;
  __syncthreads();

  if (c0 < row.width) {
    const long long lo = static_cast<long long>(f) * p_max;
    for (long long i = lo + threadIdx.x; i < lo + p_max; i += kThreads) {
      const float v = vals[i];
      if (v == 0.0f) continue;  // padding
      uint32_t cell;
      float add;
      if (sketch::locate(row, keys[i], ts[i], v, c0, w_blk, &cell, &add))
        atomicAdd(&tile[cell], add);
    }
  }
  __syncthreads();

  float* o = out + static_cast<size_t>(f) * n_sub_max * width_max + c0;
  const int cols = min(w_blk, width_max - static_cast<int>(c0));
  const int n_out = n_sub_max * cols;
  for (int i = threadIdx.x; i < n_out; i += kThreads) {
    const int s = i / cols;
    const int j = i - s * cols;
    o[static_cast<size_t>(s) * width_max + j] = tile[s * w_blk + j];
  }
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a block of the current device may opt in
// to, in bytes.
int fleet_dense_max_smem(int* bytes) { return sketch_max_smem(bytes); }

// Launch on `stream`; allocates nothing.  Returns cudaGetLastError().
int fleet_dense_launch(const void* keys, const void* vals, const void* ts,
                       const void* params, void* out, int n_frags,
                       long long p_max, int n_sub_max, int width_max,
                       int w_blk, int log2_te, int is_signed, void* stream) {
  const size_t smem = static_cast<size_t>(n_sub_max) * w_blk * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fleet_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_frags, (width_max + w_blk - 1) / w_blk);
  fleet_dense_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const float*>(vals),
      static_cast<const uint32_t*>(ts), static_cast<const int32_t*>(params),
      static_cast<float*>(out), p_max, n_sub_max, width_max, w_blk, log2_te,
      is_signed);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
