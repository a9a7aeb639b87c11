// Device helpers shared by the quorum kernels (kth_largest.cu and
// quorum_phase.cu): the rank-select behind Raft's quorum tally, a thread's
// and a warp tile's, and floor-mod, which the plain torch code gets from
// `%` on int32.
#pragma once

#include <stdint.h>

namespace quorum {

constexpr int kThreads = 256;

// The k-th largest (1-based) of v[0..P), held in registers (the unrolled
// instantiations, P <= 8). Each
// lane's tie-broken descending rank (ties go to the lower lane) comes from
// O(P^2) compares; exactly one lane has rank k-1 while 1 <= k <= P, and its
// value is the result. No sort, no shared memory; INT_MIN lanes rank like
// any other value, so the result equals the plain torch version (masked
// max-extraction) bit for bit.
template <int P>
__device__ __forceinline__ int32_t kth_select(const int32_t (&v)[P], int k) {
  int32_t res = 0;
#pragma unroll
  for (int r = 0; r < P; ++r) {
    int rank = 0;
#pragma unroll
    for (int s = 0; s < P; ++s)
      rank += (v[s] > v[r]) || (v[s] == v[r] && s < r);
    if (rank == k - 1) res = v[r];
  }
  return res;
}

// ---- warp tiles (phase 3 up to 8 peers, and past 8 every quorum kernel) ---
//
// A tile is W (4, 8, 16 or 32) consecutive threads of a warp that together
// own one group, thread `lane` of the tile owning peer `lane` (and, past 32
// peers, lane + 32, lane + 64, ...). A warp holds 32 / W tiles. Every
// thread of the warp calls these helpers together, with the same trip
// counts: a tile past the last group runs on clamped inputs and stores
// nothing, so the whole warp stays converged for the shuffles.

// This thread's lane in its tile, and the tile's first lane in the warp.
template <int W>
__device__ __forceinline__ int tile_lane() { return threadIdx.x % W; }
template <int W>
__device__ __forceinline__ int tile_shift() {
  return threadIdx.x % 32 / W * W;
}

// The tile's lanes as a warp mask, for the __reduce_*_sync reductions.
template <int W>
__device__ __forceinline__ uint32_t tile_mask() {
  if constexpr (W == 32) return ~0u;
  else return ((1u << W) - 1) << tile_shift<W>();
}

// A warp-wide lane mask cut to the tile: bit i for its lane i.
template <int W>
__device__ __forceinline__ uint32_t tile_bits(uint32_t warp_bits) {
  return (warp_bits & tile_mask<W>()) >> tile_shift<W>();
}

// The tile's ballot of `pred`.
template <int W>
__device__ __forceinline__ uint32_t tile_ballot(bool pred) {
  return tile_bits<W>(__ballot_sync(~0u, pred));
}

// The k-th largest (1-based) of the n values a tile holds in registers:
// at(j) is this lane's value for peer lane + j*W, j < chunks (chunks = 1
// for n <= W, as a constant, so at(0) is one register), and INT32_MIN for
// a peer at or past n, which then never outranks a peer below n. Each lane
// counts its value's tie-broken descending rank, the count of kth_select:
// the values above its own, one shuffle and one compare for each lane of
// the tile (O(n) a lane, no memory), plus the equal values of lower lanes,
// which one __match_any_sync names for its own chunk (a lower chunk's equal
// values all count). The ballot of rank == k-1 names the one lane whose
// value a last shuffle hands to the whole tile; 0 when no lane has that
// rank (k outside 1..n), as in kth_select. The same result bit for bit.
template <int W, typename At>
__device__ __forceinline__ int32_t tile_kth_select(At at, int chunks, int n,
                                                   int k) {
  const int lane = tile_lane<W>();
  const uint32_t below = (1u << lane) - 1;
  int32_t res = 0;
  for (int j = 0; j < chunks; ++j) {
    const int32_t vr = at(j);
    int rank = __popc(tile_bits<W>(__match_any_sync(~0u, vr)) & below);
    for (int jj = 0; jj < chunks; ++jj) {
      const int32_t vc = jj == j ? vr : at(jj);
      const bool lower = jj < j;      // its equal values outrank this one
#pragma unroll
      for (int s = 0; s < W; ++s) {
        const int32_t vs = __shfl_sync(~0u, vc, s, W);
        rank += lower ? vs >= vr : vs > vr;
      }
    }
    const uint32_t hit = tile_ballot<W>(lane + j * W < n && rank == k - 1);
    const int32_t v = __shfl_sync(~0u, vr, hit ? __ffs(hit) - 1 : 0, W);
    if (hit) res = v;
  }
  return res;
}

// Lanes a membership word can name: one bit a lane, as the reference's
// int32 bitmask holds them.
constexpr int kMaxMemberLanes = 32;

// The quorum of a membership bitmask: half its members, plus one. The word's
// every bit counts, as jax.lax.population_count counts them in the reference.
__device__ __forceinline__ int of_members(uint32_t members) {
  return __popc(members) / 2 + 1;
}

// a mod m with the sign of m (m > 0 gives 0..m-1), as torch's `%` on
// integers computes it. C's `%` truncates: (-1) % 64 is -1, which would
// index one slot before a ring row.
__device__ __forceinline__ int32_t floormod(int32_t a, int32_t m) {
  const int32_t r = a % m;
  return (r != 0 && ((r < 0) != (m < 0))) ? r + m : r;
}

}  // namespace quorum
