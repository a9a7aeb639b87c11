// Quorum tally for the batched Raft step: per group, the k-th largest
// (1-based) of x[g, 0..P) — Raft's quorum median over applied_index
// (backpressure floor) and over matchIndex with the leader's own
// last_index (commit candidate).
//
// Replaces the TPU kernel copycat_tpu/ops/pallas_kernels.py::_kth_kernel
// (launched by kth_largest_pallas), which ran on a [P, G] transpose with
// the group axis on the vector lanes. Here one thread owns one group: it
// loads the group's P lanes into registers (P <= 8, one unrolled
// instantiation each) and rank-selects them (quorum.cuh) — no sort, no
// shared memory, no transpose. Wider groups (P > 8) take one runtime-P
// instantiation that rank-selects the row where it lies in device memory. The step no
// longer launches it: the same select runs inside the two fused phase
// kernels of quorum_phase.cu. This kernel stays the direct counterpart of
// _kth_kernel and is held against the plain torch version.
//
// Bound on an H100: the function moves G*P*4 + G*4 bytes (160 KB at the
// bench shape G=10,000, P=3), about 0.05 us at 3.35 TB/s, and does a few
// dozen integer compares per group; a single launch costs more than
// either, so the kernel is bound by launch latency. Adjacent threads read
// adjacent P-int rows, so every 128-byte line a warp touches is used in
// full.
//
// Built by copycat_tpu_torch/ops/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C function below with ctypes.

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

// P > 8: the same select over the row in device memory (L1 holds it).
__global__ void kth_largest_kernel_n(const int32_t* __restrict__ x,
                                     int32_t* __restrict__ out, int G, int P,
                                     int k) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const int32_t* row = x + static_cast<size_t>(g) * P;
  out[g] = quorum::kth_select_n([row](int s) { return row[s]; }, P, k);
}

template <int P>
void launch(const int32_t* x, int32_t* out, int G, int k, cudaStream_t s) {
  const int blocks = (G + quorum::kThreads - 1) / quorum::kThreads;
  kth_largest_kernel<P><<<blocks, quorum::kThreads, 0, s>>>(x, out, G, k);
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
      kth_largest_kernel_n<<<(G + quorum::kThreads - 1) / quorum::kThreads,
                             quorum::kThreads, 0, s>>>(xi, oi, G, P, k);
  }
  return static_cast<int>(cudaGetLastError());
}
