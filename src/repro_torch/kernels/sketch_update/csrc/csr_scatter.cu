// CSR scatter for Hopper (sm_90a): builds kernel B1's packet stream on the
// card from a window's packets as they were staged, unpadded.
//
// Replaces no TPU kernel: the reference builds this stream on the host
// (`pack_csr` in src/repro/core/fleet.py, after `FleetPacket.select` of a
// row group's fragments), and so does the port on the CPU.  On the card the
// host stages the window's raw packets once, epoch-major in each epoch's
// fragment order, and uploads them; this kernel then lays out one row
// group's (epoch, fragment) rows as B1 reads them (fleet_ragged.cu).
//
// What it computes: slot q of the (n_blocks * blk) output belongs to stream
// block b = q / blk, whose packet row is r = block_row[b]; with
// s = q - first_blk[r] * blk, the slot holds staged packet src_off[r] + s
// when s < row_len[r], and zeros (value-0 padding) otherwise.  So a row's
// segment lies at the start of its blocks, padded to a blk boundary, and
// the trailing bucket blocks (mapped to the last row) are all zeros: the
// bits of pack_csr's output, padding included.  The tables come from
// core/fleet.py csr_row_tables.
//
// With n_levels > 1 it also folds each live packet's UnivMon level into its
// ts word, as fold_packet_flags (core/fleet.py) does on the host: the slot
// holds (ts & te_mask) | (level << 24), with the key's level hashed as
// core/hashing.py level_of hashes it (sketch_hash.cuh's hash_u32 under
// level_seed; the number of trailing ones of its n_levels - 1 low bits).
// The staged ts are then the raw ones; padding stays all zeros.  n_levels
// is a launch argument, so the branch is uniform and n_levels == 1 copies
// the ts as staged.  §4.4's single-hop bit is no hash of the key: a fleet
// with mitigation folds the whole word on the host and launches with 1.
//
// Design: one thread a quad of output slots (blk is a multiple of 4, so a
// quad never straddles two blocks).  The quad's row comes from one read of
// block_row and three of the row tables (a warp's quads share them, in L1);
// its up to 4 staged packets are scalar reads, since a row's segment starts
// at any packet; each output takes one 16-byte store.
//
// What bounds it on the H100: bytes.  12 B read a live packet (key, value,
// timestamp) and 12 B written a slot; the tables are a few KB a row group.
// The level fold adds about a dozen integer ops a live packet and no byte.
#include <cstdint>
#include <cuda_runtime.h>

#include "sketch_hash.cuh"

namespace {

// core/hashing.py level_of for n_levels in [2, 32]: the lowest clear bit of
// the key's n_levels - 1 sampling bits, or n_levels - 1 when all are set.
__device__ __forceinline__ uint32_t level_of(uint32_t key, uint32_t seed,
                                             int n_levels) {
  const uint32_t mask = (1u << (n_levels - 1)) - 1u;
  const uint32_t inv = ~sketch::hash_u32(key, seed) & mask;
  return inv ? static_cast<uint32_t>(__ffs(static_cast<int>(inv)) - 1)
             : static_cast<uint32_t>(n_levels - 1);
}

constexpr int kThreads = 256;
constexpr int kSlots = 4;  // output slots a thread: one 16-byte store each

__global__ void __launch_bounds__(kThreads)
csr_scatter_kernel(const uint32_t* __restrict__ keys,
                   const float* __restrict__ vals,
                   const uint32_t* __restrict__ ts,
                   const long long* __restrict__ src_off,
                   const long long* __restrict__ row_len,
                   const long long* __restrict__ first_blk,
                   const long long* __restrict__ block_row,
                   uint4* __restrict__ keys_out, float4* __restrict__ vals_out,
                   uint4* __restrict__ ts_out, long long n_quads, int blk,
                   uint32_t te_mask, uint32_t level_seed, int n_levels) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n_quads) return;
  const long long q = t * kSlots;
  const long long r = block_row[q / blk];
  const long long s = q - first_blk[r] * blk;
  const long long live = row_len[r] - s;  // staged packets left from slot s
  const long long i = src_off[r] + s;
  uint32_t k[kSlots] = {0u, 0u, 0u, 0u}, u[kSlots] = {0u, 0u, 0u, 0u};
  float v[kSlots] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    if (j < live) {
      k[j] = keys[i + j];
      v[j] = vals[i + j];
      u[j] = ts[i + j];
      if (n_levels > 1)
        u[j] = (u[j] & te_mask) |
               (level_of(k[j], level_seed, n_levels) << sketch::kLvlShift);
    }
  }
  keys_out[t] = make_uint4(k[0], k[1], k[2], k[3]);
  vals_out[t] = make_float4(v[0], v[1], v[2], v[3]);
  ts_out[t] = make_uint4(u[0], u[1], u[2], u[3]);
}

}  // namespace

extern "C" {

// Launch `grid` CTAs on `stream`, one thread a quad of the n_quads * 4
// output slots; writes every slot of the three outputs, which must be
// 16-byte aligned, and allocates nothing.  n_levels > 1 (at most 32) folds
// each live slot's level into its ts word; 1 copies it.  Returns
// cudaGetLastError().
int csr_scatter_launch(const void* keys, const void* vals, const void* ts,
                       const void* src_off, const void* row_len,
                       const void* first_blk, const void* block_row,
                       void* keys_out, void* vals_out, void* ts_out,
                       long long n_quads, int grid, int blk,
                       unsigned te_mask, unsigned level_seed, int n_levels,
                       void* stream) {
  csr_scatter_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const float*>(vals),
      static_cast<const uint32_t*>(ts),
      static_cast<const long long*>(src_off),
      static_cast<const long long*>(row_len),
      static_cast<const long long*>(first_blk),
      static_cast<const long long*>(block_row),
      static_cast<uint4*>(keys_out), static_cast<float4*>(vals_out),
      static_cast<uint4*>(ts_out), n_quads, blk, te_mask, level_seed,
      n_levels);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
