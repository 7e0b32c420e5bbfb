// Ragged CSR fleet sketch update for Hopper (sm_90a).
//
// Replaces the TPU kernel `fleet_ragged_kernel` / `fleet_update_ragged_pallas`
// (src/repro/kernels/sketch_update/fleet.py), whose body is
// `_frag_contrib` -> `block_contrib` (src/repro/kernels/sketch_update/kernel.py).
//
// What it computes: the subepoch-record counters of every param row of a
// fleet window.  Rows are (epoch, fragment[, UnivMon level]) tuples; packet
// row `pr` owns CSR blocks [row_start[pr], row_start[pr+1]) of the flat
// keys/vals/ts stream, and virtual row `r` reads packet row `r / n_levels`.
// The per-packet hashing and §4.1 / §4.4 / UnivMon mask are shared with
// the other update kernels (sketch_hash.cuh).
//
// Design (simple and right first): one CTA per (param row, width block of
// w_blk columns).  The row's n_sub_max x w_blk f32 tile lives in dynamic
// shared memory: it is zeroed, updated with shared-memory atomicAdd while
// the CTA walks the row's CSR range, and written out once — so every output
// element is written exactly once and no separate zero pass is needed.
// Width blocks past the row's width skip the packets and write zeros.
// Counters are sums of integers below 2^24 (enforced by the caller's peak
// check), so f32 addition is exact and the order of the atomics cannot
// change a bit.
//
// What bounds it on the H100: memory.  Each CTA reads its row's stream
// (12 B per packet) once per width block, and the launch writes
// rows * n_sub_max * width_max * 4 B.  The re-read of the stream per width
// block is the known cost of this design, left to a later change (e.g. one
// pass that bins packets by width block first).
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "sketch_hash.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
fleet_ragged_kernel(const uint32_t* __restrict__ keys,
                    const float* __restrict__ vals,
                    const uint32_t* __restrict__ ts,
                    const int32_t* __restrict__ params,
                    const int32_t* __restrict__ row_start,
                    float* __restrict__ out, int n_levels, int n_sub_max,
                    int width_max, int w_blk, int blk, int log2_te,
                    int is_signed, int with_levels, int with_mit) {
  extern __shared__ float tile[];
  const int r = blockIdx.x;
  const uint32_t c0 = static_cast<uint32_t>(blockIdx.y) * w_blk;
  const sketch::Row row = sketch::row_from_params(
      params + static_cast<size_t>(r) * sketch::kNParams, log2_te,
      is_signed != 0, with_levels != 0, with_mit != 0);

  const int tile_n = n_sub_max * w_blk;
  for (int i = threadIdx.x; i < tile_n; i += kThreads) tile[i] = 0.0f;
  __syncthreads();

  if (c0 < row.width) {
    const int pr = r / n_levels;
    const size_t lo = static_cast<size_t>(row_start[pr]) * blk;
    const size_t hi = static_cast<size_t>(row_start[pr + 1]) * blk;
    for (size_t i = lo + threadIdx.x; i < hi; i += kThreads) {
      const float v = vals[i];
      if (v == 0.0f) continue;  // blk / bucket padding
      uint32_t cell;
      float add;
      if (sketch::locate(row, keys[i], ts[i], v, c0, w_blk, &cell, &add))
        atomicAdd(&tile[cell], add);
    }
  }
  __syncthreads();

  float* o = out + static_cast<size_t>(r) * n_sub_max * width_max + c0;
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
int fleet_ragged_max_smem(int* bytes) { return sketch_max_smem(bytes); }

// Launch on `stream`; allocates nothing.  Returns cudaGetLastError().
int fleet_ragged_launch(const void* keys, const void* vals, const void* ts,
                        const void* params, const void* row_start, void* out,
                        int n_rows, int n_levels, int n_sub_max,
                        int width_max, int w_blk, int blk, int log2_te,
                        int is_signed, int with_levels, int with_mit,
                        void* stream) {
  const size_t smem = static_cast<size_t>(n_sub_max) * w_blk * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fleet_ragged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_rows, (width_max + w_blk - 1) / w_blk);
  fleet_ragged_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const float*>(vals),
      static_cast<const uint32_t*>(ts), static_cast<const int32_t*>(params),
      static_cast<const int32_t*>(row_start), static_cast<float*>(out),
      n_levels, n_sub_max, width_max, w_blk, blk, log2_te, is_signed,
      with_levels, with_mit);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
