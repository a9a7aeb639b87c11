// Device helpers shared by the quorum kernels (kth_largest.cu and
// quorum_phase.cu): the rank-select behind Raft's quorum tally, and
// floor-mod, which the plain torch code gets from `%` on int32.
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

// The same select over n lanes known only at run time (P > 8), each value
// read through at(s) — a row in device memory, or a lane the caller
// computes. The same tie-broken count, so the same result bit for bit.
template <typename At>
__device__ __forceinline__ int32_t kth_select_n(At at, int n, int k) {
  int32_t res = 0;
  for (int r = 0; r < n; ++r) {
    const int32_t vr = at(r);
    int rank = 0;
    for (int s = 0; s < n; ++s) {
      const int32_t vs = at(s);
      rank += (vs > vr) || (vs == vr && s < r);
    }
    if (rank == k - 1) res = vr;
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
