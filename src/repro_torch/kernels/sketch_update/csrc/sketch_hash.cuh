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

// Where one packet lands in a row of `stride` columns (the output's row
// stride, at least the row's width): false when it is not monitored;
// otherwise the cell `sub * stride + col` and the signed value to add.
__device__ __forceinline__ bool locate(const Row& r, uint32_t key,
                                       uint32_t t, float v, uint32_t stride,
                                       uint32_t* cell, float* add) {
  if (r.with_levels &&
      static_cast<int>((t >> kLvlShift) & kLvlMask) < r.level)
    return false;
  const uint32_t col = hash_mod(key, r.col_seed, r.width);
  const uint32_t sub_pkt = (t >> r.shift) & r.n_mask;
  const uint32_t sub_flow = hash_u32(key, r.sub_seed) & r.n_mask;
  bool monitored = sub_pkt == sub_flow;
  if (r.mit && !monitored) {
    const uint32_t sub2 = (sub_flow + ((r.n_mask + 1u) >> 1)) & r.n_mask;
    monitored = ((t >> kShShift) != 0u) && sub_pkt == sub2;
  }
  if (!monitored) return false;
  if (r.is_signed && (hash_u32(key, r.sign_seed) & 1u)) v = -v;
  *cell = sub_pkt * stride + col;
  *add = v;
  return true;
}

constexpr unsigned kWarp = 0xFFFFFFFFu;
constexpr uint32_t kNoCell = 0xFFFFFFFFu;
constexpr float kExact = 16777216.0f;  // 2^24

// Four packets of one row (one 16-byte load each of keys, timestamps and
// values) into the row's (n_sub_max, width_max) counter slab (locate's
// stride is width_max): value-0 padding and unmonitored packets
// add nothing.  Adds that hit one counter are summed before the atomic,
// since same-address atomics serialise in L2:
//   1. within the thread: its four packets, often consecutive packets of
//      one bursty flow;
//   2. within the warp, among the lanes whose counter a neighbouring lane
//      also holds (a heavy hitter's): __match_any_sync groups them by
//      address (its cost grows with the distinct values it sees, so the
//      other lanes all present 0), __reduce_add_sync sums each group, and
//      the group's lowest lane adds the sum.  A warp where no lane shares a
//      counter with a neighbour skips the match.
// The neighbour test only picks which lanes to group; the grouping itself
// is by address, so it cannot merge two counters.  Only integer adds below
// 2^24 join a group (the main path's values are packet counts, and the
// caller bounds cs and um input mass and every cms counter below 2^24), so
// a group's int sum is exact and grouping changes no bit; any other add (a
// fraction, or one past the contract, which must still reach the caller's
// peak check) takes its own atomic, as the plain version adds it.  Every
// lane of the warp
// must call it (uniform control flow).  The atomics' returns are unused,
// so they compile to reductions (RED) that resolve in L2.
__device__ __forceinline__ void add_quad(const Row& r, const uint4& k,
                                         const uint4& t, const float4& v,
                                         float* slab, uint32_t width_max) {
  const uint32_t keys[4] = {k.x, k.y, k.z, k.w};
  const uint32_t ts[4] = {t.x, t.y, t.z, t.w};
  const float vals[4] = {v.x, v.y, v.z, v.w};
  uint32_t cell[4] = {0u, 0u, 0u, 0u};
  float add[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  bool ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    ok[i] = vals[i] != 0.0f &&
            locate(r, keys[i], ts[i], vals[i], width_max, &cell[i],
                   &add[i]);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = i + 1; j < 4; ++j)
      if (ok[i] && ok[j] && cell[i] == cell[j]) {
        add[i] += add[j];
        ok[j] = false;
      }
  const unsigned lane = threadIdx.x & 31u;
  uint32_t mine[4], theirs[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) mine[i] = ok[i] ? cell[i] : kNoCell;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    theirs[i] = __shfl_sync(kWarp, mine[i], (lane + 31u) & 31u);
    theirs[4 + i] = __shfl_sync(kWarp, mine[i], (lane + 1u) & 31u);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bool shared = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) shared |= mine[i] == theirs[j];
    shared &= ok[i] && fabsf(add[i]) < kExact && add[i] == rintf(add[i]);
    float* addr = slab + cell[i];
    if (__any_sync(kWarp, shared)) {
      const unsigned peers = __match_any_sync(
          kWarp, shared ? reinterpret_cast<unsigned long long>(addr) : 0ull);
      const int sum =
          __reduce_add_sync(peers, shared ? __float2int_rn(add[i]) : 0);
      if (shared && lane == static_cast<unsigned>(__ffs(peers) - 1))
        atomicAdd(addr, static_cast<float>(sum));
    }
    if (ok[i] && !shared) atomicAdd(addr, add[i]);
  }
}

}  // namespace sketch
