// Device helpers shared by the quorum kernels (kth_largest.cu and
// quorum_phase.cu): the rank-select behind Raft's quorum tally, and
// floor-mod, which the plain torch code gets from `%` on int32.
#pragma once

#include <stdint.h>

namespace quorum {

constexpr int kThreads = 256;

// The k-th largest (1-based) of v[0..P), P <= 8, held in registers. Each
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

// a mod m with the sign of m (m > 0 gives 0..m-1), as torch's `%` on
// integers computes it. C's `%` truncates: (-1) % 64 is -1, which would
// index one slot before a ring row.
__device__ __forceinline__ int32_t floormod(int32_t a, int32_t m) {
  const int32_t r = a % m;
  return (r != 0 && ((r < 0) != (m < 0))) ? r + m : r;
}

}  // namespace quorum
