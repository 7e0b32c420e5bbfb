// Single-fragment sketch update for Hopper (sm_90a).
//
// Replaces the TPU kernel `sketch_update_kernel` / `sketch_update_pallas`
// (src/repro/kernels/sketch_update/kernel.py), whose body is
// `block_contrib`.
//
// What it computes: the (n_sub, width) subepoch-record counters of one
// fragment epoch, with the seeds, level and §4.4 flag passed as arguments
// (the fleet kernels read them from a parameter table).  The per-packet
// hashing and mask are sketch_hash.cuh's, shared with the fleet kernels.
//
// Design (simple and right first): one fragment has one row, so the fleet
// kernels' one-CTA-per-(row, width block) grid would give a 123974-wide
// fragment at n_sub = 1 four CTAs on 132 SMs, each walking every packet.
// The grid here also splits the packet axis: CTA (x, y) owns width block x
// (w_blk columns) and packet chunk y.  Its n_sub x w_blk f32 tile lives in
// dynamic shared memory, is zeroed, updated with shared-memory atomicAdd
// over the chunk, and its non-zero cells are then added into the output
// (zeroed by the caller) with global atomicAdd.  Counters are sums of
// integers below 2^24 (the caller's peak check), so f32 addition is exact
// and neither atomic order can change a bit.
//
// What bounds it on the H100: memory.  Each packet (12 B) is read once per
// width block, and the output (n_sub * width * 4 B) is written once plus
// one read-modify-write per non-zero cell of each chunk's tile.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "sketch_hash.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
sketch_update_kernel(const uint32_t* __restrict__ keys,
                     const float* __restrict__ vals,
                     const uint32_t* __restrict__ ts,
                     float* __restrict__ out, long long n_packets,
                     long long chunk, int n_sub, int w_blk,
                     sketch::Row row) {
  extern __shared__ float tile[];
  const uint32_t c0 = static_cast<uint32_t>(blockIdx.x) * w_blk;
  const long long lo = static_cast<long long>(blockIdx.y) * chunk;
  const long long hi = min(lo + chunk, n_packets);

  const int tile_n = n_sub * w_blk;
  for (int i = threadIdx.x; i < tile_n; i += kThreads) tile[i] = 0.0f;
  __syncthreads();

  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    const float v = vals[i];
    if (v == 0.0f) continue;  // blk padding
    uint32_t cell;
    float add;
    if (sketch::locate(row, keys[i], ts[i], v, c0, w_blk, &cell, &add))
      atomicAdd(&tile[cell], add);
  }
  __syncthreads();

  const int width = static_cast<int>(row.width);
  const int cols = min(w_blk, width - static_cast<int>(c0));
  const int n_out = n_sub * cols;
  float* o = out + c0;
  for (int i = threadIdx.x; i < n_out; i += kThreads) {
    const int s = i / cols;
    const int j = i - s * cols;
    const float x = tile[s * w_blk + j];
    if (x != 0.0f) atomicAdd(&o[static_cast<size_t>(s) * width + j], x);
  }
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a block of the current device may opt in
// to, in bytes.
int sketch_update_max_smem(int* bytes) { return sketch_max_smem(bytes); }

// Launch on `stream` into `out`, an (n_sub, width) f32 buffer the caller
// zeroed; allocates nothing.  Returns cudaGetLastError().
int sketch_update_launch(const void* keys, const void* vals, const void* ts,
                         void* out, long long n_packets, long long chunk,
                         int n_chunks, int width, int n_sub, int log2_n_sub,
                         int w_blk, int log2_te, int col_seed, int sign_seed,
                         int sub_seed, int level, int mitigation,
                         int is_signed, void* stream) {
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
  const size_t smem = static_cast<size_t>(n_sub) * w_blk * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sketch_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((width + w_blk - 1) / w_blk, n_chunks);
  sketch_update_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const float*>(vals),
      static_cast<const uint32_t*>(ts), static_cast<float*>(out), n_packets,
      chunk, n_sub, w_blk, row);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
