// Quorum tally for the batched Raft step: per group, the k-th largest
// (1-based) of x[g, 0..P) — Raft's quorum median over applied_index
// (backpressure floor) and over matchIndex with the leader's own
// last_index (commit candidate).
//
// Replaces the TPU kernel copycat_tpu/ops/pallas_kernels.py::_kth_kernel
// (launched by kth_largest_pallas), which ran on a [P, G] transpose with
// the group axis on the vector lanes. The step no longer launches it: the
// same select runs inside the two fused phase kernels of quorum_phase.cu.
// This kernel stays the direct counterpart of _kth_kernel and is held
// against the plain torch version. Two layouts:
//
// - P <= 8: one thread owns one group. It loads the group's P lanes into
//   registers (one unrolled instantiation for each P) and rank-selects
//   them (quorum::kth_select): no sort, no shared memory, no transpose.
//   Adjacent threads read adjacent P-int rows, so every 128-byte line a
//   warp touches is used in full.
// - P > 8: a tile of W threads owns one group, as in quorum_phase.cu's
//   *_tile kernels: W = 16 up to 16 peers (two groups a warp), 32 above.
//   Thread `lane` of the tile owns peer `lane`, and past 32 peers also
//   lane + 32, lane + 64, ... Each thread loads its own elements of the
//   row, so a tile's loads are one contiguous segment and a warp's are
//   coalesced; a peer at or past P enters as INT32_MIN, which never
//   outranks a real one. quorum::tile_kth_select ranks each lane's value
//   with O(P) shuffles, one __match_any_sync for ties and a ballot: the
//   same tie-broken rank as the thread-a-group select, so the same result
//   bit for bit, and no row is ever read twice from memory. Up to
//   kMaxRegChunks * 32 = 128 peers a thread keeps its ceil(P/32) values in
//   registers (read from memory once, selected by index from a fixed
//   array); past that, which no Raft group comes near, it reads them again
//   from the row at each pass of the select (L1 holds it), as the fused
//   tiles do past 32 peers, so its registers stay bounded whatever P is.
//   A tile past the last group runs on the last group's row and stores
//   nothing, so every warp stays converged for the shuffles.
//
// Bound on an H100: the function moves G*P*4 + G*4 bytes (160 KB at the
// bench shape G=10,000, P=3, about 0.05 us at 3.35 TB/s; 1.32 MB at P=32,
// 0.39 us) and does a few dozen integer compares per peer; a single launch
// costs more than either, so the kernel is bound by launch latency.
// Measured (chip_smoke.py: 100 calls in one CUDA graph, replayed 20 times;
// NVIDIA H100 80GB HBM3, 700 W) at G=10,000 on drawn rows: P=3 0.0011 ms;
// P = 9 / 16 / 32 / 33: 0.0024 / 0.0028 / 0.0049 / 0.0091 ms, where the
// thread-a-group form took 0.0035 / 0.0192 / 0.1373 / 0.0412 and
// torch.topk 0.034 / 0.035 / 0.036 / 0.053. Past 32 peers each lane ranks
// its two values against both chunks of the tile, four passes of shuffles.
#include <cuda_runtime.h>
#include <stdint.h>

#include "quorum.cuh"

namespace {

template <int P>
__global__ void kth_largest_kernel(const int32_t* __restrict__ x,
                                   int32_t* __restrict__ out, int G, int k) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const int32_t* row = x + static_cast<size_t>(g) * P;
  int32_t v[P];
#pragma unroll
  for (int p = 0; p < P; ++p) v[p] = row[p];
  out[g] = quorum::kth_select<P>(v, k);
}

// P > 8: a warp tile a group (see the head of this file). Chunks is 1 as
// a constant (P <= W, the peer's value in one register), kMaxRegChunks
// (ceil(P/32) <= kMaxRegChunks values in registers), or 0 for ceil(P/32)
// values read again from the row (P > 32 * kMaxRegChunks).
constexpr int kMaxRegChunks = 4;

template <int N>
__device__ __forceinline__ int32_t pick(const int32_t (&v)[N], int j) {
  int32_t r = v[0];
#pragma unroll
  for (int i = 1; i < N; ++i)
    if (j == i) r = v[i];
  return r;
}

template <int W, int Chunks>
__global__ void kth_largest_tile_kernel(const int32_t* __restrict__ x,
                                        int32_t* __restrict__ out, int G,
                                        int P, int k) {
  const int lane = quorum::tile_lane<W>();
  const int g = blockIdx.x * (blockDim.x / W) + threadIdx.x / W;
  const int32_t* row = x + static_cast<size_t>(min(g, G - 1)) * P;
  constexpr int kRegs = Chunks > 0 ? Chunks : 1;
  int32_t v[kRegs];
#pragma unroll
  for (int j = 0; j < kRegs; ++j) {
    const int p = lane + j * W;
    v[j] = Chunks > 0 && p < P ? row[p] : INT32_MIN;
  }
  const int chunks = Chunks == 1 ? 1 : (P + W - 1) / W;
  const int32_t res = quorum::tile_kth_select<W>(
      [&](int j) -> int32_t {
        if constexpr (Chunks > 0) {
          return pick(v, j);
        } else {
          const int p = lane + j * W;
          return p < P ? row[p] : INT32_MIN;
        }
      },
      chunks, P, k);
  if (g < G && lane == 0) out[g] = res;
}

template <int P>
void launch(const int32_t* x, int32_t* out, int G, int k, cudaStream_t s) {
  const int blocks = (G + quorum::kThreads - 1) / quorum::kThreads;
  kth_largest_kernel<P><<<blocks, quorum::kThreads, 0, s>>>(x, out, G, k);
}

// kThreads / W groups a block.
template <int W, int Chunks>
void launch_tile(const int32_t* x, int32_t* out, int G, int P, int k,
                 cudaStream_t s) {
  constexpr int groups = quorum::kThreads / W;
  const int blocks = (G + groups - 1) / groups;
  kth_largest_tile_kernel<W, Chunks><<<blocks, quorum::kThreads, 0, s>>>(
      x, out, G, P, k);
}

}  // namespace

// x: [G, P] int32, contiguous, on the device; out: [G] int32. P >= 1 and
// 1 <= k <= P (the wrapper checks both). Launches on ``stream`` and
// returns cudaGetLastError() — nonzero means the launch was refused.
extern "C" int kth_largest_launch(const void* x, void* out, int G, int P,
                                  int k, void* stream) {
  if (G <= 0) return 0;
  const int32_t* xi = static_cast<const int32_t*>(x);
  int32_t* oi = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 1: launch<1>(xi, oi, G, k, s); break;
    case 2: launch<2>(xi, oi, G, k, s); break;
    case 3: launch<3>(xi, oi, G, k, s); break;
    case 4: launch<4>(xi, oi, G, k, s); break;
    case 5: launch<5>(xi, oi, G, k, s); break;
    case 6: launch<6>(xi, oi, G, k, s); break;
    case 7: launch<7>(xi, oi, G, k, s); break;
    case 8: launch<8>(xi, oi, G, k, s); break;
    default:
      if (P < 1) return static_cast<int>(cudaErrorInvalidValue);
      if (P <= 16) launch_tile<16, 1>(xi, oi, G, P, k, s);
      else if (P <= 32) launch_tile<32, 1>(xi, oi, G, P, k, s);
      else if (P <= 32 * kMaxRegChunks)
        launch_tile<32, kMaxRegChunks>(xi, oi, G, P, k, s);
      else launch_tile<32, 0>(xi, oi, G, P, k, s);
  }
  return static_cast<int>(cudaGetLastError());
}
