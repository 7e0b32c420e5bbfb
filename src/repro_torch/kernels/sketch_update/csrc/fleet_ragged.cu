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
// For each packet the kernel hashes, in uint32 arithmetic exactly as the
// reference does:
//   col      = Lemire fast range of hash(key, col_seed) into [0, width), in
//              16-bit limbs (wraps for width > 65536, as the reference does);
//   sign     = 1 - 2 * (hash(key, sign_seed) & 1)           (cs / um only);
//   sub_pkt  = (ts >> (log2_te - log2 n)) & (n - 1)         (Method 2, §5);
//   sub_flow = hash(key, sub_seed) & (n - 1)                (§4.1);
// and adds value * sign into out[r, sub_pkt, col] iff the packet is
// monitored: sub_pkt == sub_flow, or (§4.4, PARAM_MIT rows) the single-hop
// bit 31 of ts is set and sub_pkt == (sub_flow + n/2) & (n-1); UnivMon level
// rows additionally require the level id in ts bits [24, 29) >= the row's
// level.
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

namespace {

constexpr int kThreads = 512;
constexpr uint32_t kM1 = 0x7FEB352Du;
constexpr uint32_t kM2 = 0x846CA68Bu;
constexpr uint32_t kSeedMult = 2654435769u;
constexpr int kLvlShift = 24;
constexpr uint32_t kLvlMask = 0x1Fu;
constexpr int kShShift = 31;

// Columns of the int32 parameter table (kernels/sketch_update/fleet.py).
constexpr int kColSeed = 0, kSignSeed = 1, kSubSeed = 2, kWidth = 3,
              kNSub = 4, kLog2NSub = 5, kLevel = 6, kMit = 7, kNParams = 8;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x = (x ^ (x >> 16)) * kM1;
  x = (x ^ (x >> 15)) * kM2;
  return x ^ (x >> 16);
}

__device__ __forceinline__ uint32_t hash_u32(uint32_t key, uint32_t seed) {
  return mix32(key * kSeedMult + seed);
}

__device__ __forceinline__ uint32_t hash_mod(uint32_t key, uint32_t seed,
                                             uint32_t mod) {
  const uint32_t h = hash_u32(key, seed);
  const uint32_t t = (h >> 16) * mod + (((h & 0xFFFFu) * mod) >> 16);
  return t >> 16;
}

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
  const int32_t* p = params + static_cast<size_t>(r) * kNParams;
  const uint32_t col_seed = static_cast<uint32_t>(p[kColSeed]);
  const uint32_t sign_seed = static_cast<uint32_t>(p[kSignSeed]);
  const uint32_t sub_seed = static_cast<uint32_t>(p[kSubSeed]);
  const uint32_t width = static_cast<uint32_t>(p[kWidth]);
  const uint32_t n_mask = static_cast<uint32_t>(p[kNSub]) - 1u;
  const uint32_t shift = static_cast<uint32_t>(log2_te - p[kLog2NSub]);
  const int level = p[kLevel];
  const bool mit = with_mit && p[kMit] != 0;

  const int tile_n = n_sub_max * w_blk;
  for (int i = threadIdx.x; i < tile_n; i += kThreads) tile[i] = 0.0f;
  __syncthreads();

  if (c0 < width) {
    const int pr = r / n_levels;
    const size_t lo = static_cast<size_t>(row_start[pr]) * blk;
    const size_t hi = static_cast<size_t>(row_start[pr + 1]) * blk;
    for (size_t i = lo + threadIdx.x; i < hi; i += kThreads) {
      float v = vals[i];
      if (v == 0.0f) continue;  // blk / bucket padding
      const uint32_t t = ts[i];
      if (with_levels &&
          static_cast<int>((t >> kLvlShift) & kLvlMask) < level)
        continue;
      const uint32_t key = keys[i];
      const uint32_t col = hash_mod(key, col_seed, width);
      if (col < c0 || col - c0 >= static_cast<uint32_t>(w_blk)) continue;
      const uint32_t sub_pkt = (t >> shift) & n_mask;
      const uint32_t sub_flow = hash_u32(key, sub_seed) & n_mask;
      bool monitored = sub_pkt == sub_flow;
      if (mit && !monitored) {
        const uint32_t sub2 = (sub_flow + ((n_mask + 1u) >> 1)) & n_mask;
        monitored = ((t >> kShShift) != 0u) && sub_pkt == sub2;
      }
      if (!monitored) continue;
      if (is_signed && (hash_u32(key, sign_seed) & 1u)) v = -v;
      atomicAdd(&tile[sub_pkt * w_blk + (col - c0)], v);
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
// to, in bytes (232448 on an H100).
int fleet_ragged_max_smem(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
}

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
