// Per-packet arithmetic shared by the sketch update kernels (sm_90a).
//
// The body of the TPU kernels' `block_contrib`
// (src/repro/kernels/sketch_update/kernel.py), for one packet of one
// parameter row, in uint32 arithmetic exactly as the reference hashes:
//   col      = Lemire fast range of hash(key, col_seed) into [0, width), in
//              16-bit limbs (wraps for width > 65536, as the reference does);
//   sign     = 1 - 2 * (hash(key, sign_seed) & 1)           (cs / um only);
//   sub_pkt  = (ts >> (log2_te - log2 n)) & (n - 1)         (Method 2, §5);
//   sub_flow = hash(key, sub_seed) & (n - 1)                (§4.1);
// a packet is monitored iff sub_pkt == sub_flow, or (§4.4 rows) the
// single-hop bit 31 of ts is set and sub_pkt == (sub_flow + n/2) & (n-1);
// UnivMon level rows additionally require the level id in ts bits
// [24, 29) >= the row's level.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sketch {

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

// One parameter row's hashing: seeds, width, subepoch mask and shift, and
// which extended mask terms apply.
struct Row {
  uint32_t col_seed, sign_seed, sub_seed, width, n_mask, shift;
  int level;        // UnivMon level of the row; tested only if with_levels
  bool with_levels;
  bool mit;         // §4.4 second-subepoch term
  bool is_signed;
};

__device__ __forceinline__ Row row_from_params(const int32_t* p, int log2_te,
                                               bool is_signed,
                                               bool with_levels,
                                               bool with_mit) {
  Row r;
  r.col_seed = static_cast<uint32_t>(p[kColSeed]);
  r.sign_seed = static_cast<uint32_t>(p[kSignSeed]);
  r.sub_seed = static_cast<uint32_t>(p[kSubSeed]);
  r.width = static_cast<uint32_t>(p[kWidth]);
  r.n_mask = static_cast<uint32_t>(p[kNSub]) - 1u;
  r.shift = static_cast<uint32_t>(log2_te - p[kLog2NSub]);
  r.level = p[kLevel];
  r.with_levels = with_levels;
  r.mit = with_mit && p[kMit] != 0;
  r.is_signed = is_signed;
  return r;
}

// Where one packet lands in the row's column block [c0, c0 + w_blk): false
// when it is not monitored or its column lies outside the block; otherwise
// the tile cell `sub * w_blk + (col - c0)` and the signed value to add.
__device__ __forceinline__ bool locate(const Row& r, uint32_t key,
                                       uint32_t t, float v, uint32_t c0,
                                       uint32_t w_blk, uint32_t* cell,
                                       float* add) {
  if (r.with_levels &&
      static_cast<int>((t >> kLvlShift) & kLvlMask) < r.level)
    return false;
  const uint32_t col = hash_mod(key, r.col_seed, r.width);
  if (col < c0 || col - c0 >= w_blk) return false;
  const uint32_t sub_pkt = (t >> r.shift) & r.n_mask;
  const uint32_t sub_flow = hash_u32(key, r.sub_seed) & r.n_mask;
  bool monitored = sub_pkt == sub_flow;
  if (r.mit && !monitored) {
    const uint32_t sub2 = (sub_flow + ((r.n_mask + 1u) >> 1)) & r.n_mask;
    monitored = ((t >> kShShift) != 0u) && sub_pkt == sub2;
  }
  if (!monitored) return false;
  if (r.is_signed && (hash_u32(key, r.sign_seed) & 1u)) v = -v;
  *cell = sub_pkt * w_blk + (col - c0);
  *add = v;
  return true;
}

}  // namespace sketch

// The largest dynamic shared memory a block of the current device may opt
// in to, in bytes (232448 on an H100); each library exports it under its
// own name.
inline int sketch_max_smem(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
}
