// The quorum tally of the batched Raft step fused with the work around it:
// two kernels, one per site where the step takes a quorum.
//
//   admit_submits — phase 1: the backpressure tally and client admission;
//   ack_commit    — phase 3: acks to matchIndex/nextIndex, the leader lease
//                   and the quorum commit advance.
//
// Each replaces, at its site, the TPU kernel
// copycat_tpu/ops/pallas_kernels.py::_kth_kernel (launched through
// kth_largest_pallas at copycat_tpu/ops/consensus.py:646 for the
// backpressure floor and :833 for the commit candidate), together with the
// jnp around that call. The plain torch versions are
// copycat_tpu_torch/ops/kernels.py::admit_submits_plain and
// ::ack_commit_plain, which are the step's own code for these lines; the
// kernels equal them bit for bit.
//
// What bounds them on an H100: bytes, and below that, the launch. At the
// bench shape (G=10,000, P=3, S=16, L=64) admit_submits reads
// G*(4P + 4 + 1 + S + 4) = 370,000 bytes and writes G*(S + 4S + 8S + 4) =
// 2,120,000 (0.74 us at 3.35 TB/s); ack_commit reads G*(6P + 24P + 17) =
// 1,070,000 bytes plus one 4-byte term per group whose commit candidate
// lies in the ring, and writes G*(8P + 10) = 340,000 (about 0.43 us). A few
// dozen integer operations per group are far below the card's rate. Each
// is under a microsecond of work, about what one launch costs, and the
// eager torch code it replaces was a few dozen launches of its own. So the
// design keeps everything between the inputs and the outputs out of
// device memory:
//
// - one thread owns one group, so a group needs no cross-thread
//   reduction: P <= 8 lanes and the S submit slots are a loop;
// - the group's P lanes sit in registers (the kernels are templated on P,
//   so the lane loops unroll), and so do the tally, its inputs and its
//   consumers: the rank-select of quorum.cuh runs on registers and its
//   result feeds the admission or commit test directly;
// - adjacent threads read adjacent [P]-rows, so a warp uses every line of
//   the [G,P] arrays it loads in full, and each thread issues all its
//   loads before its first store;
// - admit_submits's [G,S] rows (valid in; accepted, assigned and the
//   int64 slot out, 2.3 of its 2.5 MB) are staged through shared memory:
//   a block of 128 groups and 512 threads reads and writes them as
//   contiguous segments, consecutive threads on consecutive elements,
//   rather than one thread walking a row 16 elements wide, which touches
//   a separate line for every thread of a warp at every step (13 us a
//   call at the bench shape, against 3.7 us staged, on an H100 at 700 W);
// - bool tensors are one byte of 0/1 and are read and written as uint8_t;
// - every `%` of the plain code is quorum::floormod.
//
// Dynamic membership (Config.dynamic_membership) changes the tally itself:
// the reference takes kth_largest_masked with a per-group quorum at
// copycat_tpu/ops/consensus.py:643 and :829, and counts the lease's acks over
// member lanes only (:826-828). Both kernels take an optional `view` [G,P]
// int32, each lane's active-config bitmask. Where it is given (the `Masked`
// instantiation), the kernel reads the leader lane's word itself, next to
// `lead`: the quorum is popc(word) / 2 + 1, a lane outside the word enters
// the rank-select as INT32_MIN (as kth_largest_masked does), and in
// ack_commit only member lanes count towards the lease. Where it is null the
// static instantiation runs, the same code as before: `Masked` is a template
// flag, so the static path carries no test of it. The view adds one 4-byte
// read per group.
//
// `lead` comes in unclamped (-1 for a leaderless group). The gather of the
// leader's applied_index reads lane max(lead, 0), as the plain code's
// _peer_view does; the self-lane test compares with the unclamped value, so
// a leaderless group has no self lane. Leaderless groups get every output,
// and they equal the plain version's too.
//
// Built by copycat_tpu_torch/ops/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C functions below with ctypes. Each launches
// on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "quorum.cuh"

namespace {

constexpr int kStageThreads = 4;   // admit_submits: threads per group

// ---- phase 1 --------------------------------------------------------------

// One block owns kAdmitGroups groups (fewer when S is large) with
// kStageThreads threads per group, and one thread owns one group. The
// block's [groups, S] rows of `valid` are one contiguous segment, and so
// are its rows of each output: all the block's threads stage them through
// shared memory, consecutive threads on consecutive elements, so every warp
// access to device memory is coalesced; the owning thread walks its group's
// S slots in shared memory.
template <int P, bool Masked>
__global__ void admit_submits_kernel(
    const int32_t* __restrict__ applied, const int32_t* __restrict__ view,
    const int32_t* __restrict__ lead,
    const uint8_t* __restrict__ accept_ok, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ l_last, uint8_t* __restrict__ accepted,
    int32_t* __restrict__ assigned, int64_t* __restrict__ slot,
    int32_t* __restrict__ l_last_out, int G, int S, int quorum, int L) {
  extern __shared__ int32_t smem[];
  const int T = blockDim.x;
  const int B = T / kStageThreads;                               // groups
  int32_t* s_pos = smem;                                         // [B*S]
  uint8_t* s_flag = reinterpret_cast<uint8_t*>(smem + B * S);    // [B*S]
  const int t = threadIdx.x;
  const int g0 = blockIdx.x * B;
  const int nb = min(B, G - g0);
  const int n = nb * S;
  const size_t base = static_cast<size_t>(g0) * S;
  const int g = g0 + t;
  const bool owner = t < nb;

  // The group's own inputs first, so their loads overlap the staging.
  int32_t v[P];
  int32_t ld = 0, last = 0;
  uint32_t members = 0;
  bool ok = false;
  if (owner) {
#pragma unroll
    for (int p = 0; p < P; ++p) v[p] = applied[static_cast<size_t>(g) * P + p];
    ld = max(lead[g], 0);
    ok = accept_ok[g] != 0;
    last = l_last[g];
    if constexpr (Masked)
      members = static_cast<uint32_t>(view[static_cast<size_t>(g) * P + ld]);
  }
#pragma unroll 4
  for (int e = t; e < n; e += T) s_flag[e] = valid[base + e];
  __syncthreads();

  if (owner) {
    int32_t l_applied = v[0];
#pragma unroll
    for (int p = 1; p < P; ++p)
      if (p == ld) l_applied = v[p];
    // Backpressure: the ring never overwrites an entry the leader or a
    // quorum-th replica still has to apply.
    int32_t floor_q;
    if constexpr (Masked) {
      // the quorum-th among the leader's members
      int32_t m[P];
#pragma unroll
      for (int p = 0; p < P; ++p)
        m[p] = (members >> p) & 1u ? v[p] : INT32_MIN;
      floor_q = quorum::kth_select<P>(m, quorum::of_members(members));
    } else {
      floor_q = quorum::kth_select<P>(v, quorum);
    }
    const int32_t allowed = min(l_applied, floor_q) + L;
    int32_t pos = last;
    int32_t n_acc = 0;
    for (int s = t * S; s < (t + 1) * S; ++s) {
      const bool want = ok && s_flag[s] != 0;
      pos += want;
      const bool acc = want && pos <= allowed;
      s_flag[s] = acc;
      s_pos[s] = acc ? pos : 0;
      n_acc += acc;
    }
    l_last_out[g] = last + n_acc;
  }
  __syncthreads();

#pragma unroll 4
  for (int e = t; e < n; e += T) {
    const bool acc = s_flag[e] != 0;
    const int32_t pos = s_pos[e];
    accepted[base + e] = acc;
    assigned[base + e] = pos;
    slot[base + e] = acc ? quorum::floormod(pos - 1, L) : L;
  }
}

// ---- phase 3 --------------------------------------------------------------

struct AckIn {
  const uint8_t *recv, *reject_term, *del_back, *match, *entries_sent,
      *ok_term;                                          // [G,P]
  const int32_t *upto, *prev, *term1, *last_index, *l_match, *l_next;  // [G,P]
  const int32_t* lead;                                   // [G], -1 none
  const uint8_t* active;                                 // [G]
  const int32_t *l_term, *l_last, *l_commit;             // [G]
  const int32_t* l_log_term;                             // [G, >=L] rows
  int64_t log_row_stride;
  const int32_t* view;                                   // [G,P] or null
};

struct AckOut {
  int32_t *l_match, *l_next;        // [G,P]
  uint8_t *leader_stale, *lease;    // [G]
  int32_t *max_ack_term, *l_commit;  // [G]
};

template <int P, bool Masked>
__global__ void ack_commit_kernel(const AckIn in, const AckOut out, int G,
                                  int quorum, int L) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const int32_t ld = in.lead[g];
  uint32_t members = ~0u;
  if constexpr (Masked) {
    members = static_cast<uint32_t>(
        in.view[static_cast<size_t>(g) * P + max(ld, 0)]);
    quorum = quorum::of_members(members);
  }
  const bool active = in.active[g] != 0;
  const int32_t l_term = in.l_term[g];
  const int32_t l_last = in.l_last[g];
  const int32_t l_commit = in.l_commit[g];
  bool higher = false;
  int32_t max_ack = INT32_MIN;  // a max over P lanes, each term1 or 0
  int acked = 0;
  int32_t match_full[P], l_match[P], l_next[P];
  // Every load of the group's lanes comes before any store, so the
  // compiler issues them together.
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const size_t i = static_cast<size_t>(g) * P + p;
    const bool back = in.del_back[i] != 0;
    const bool match = in.match[i] != 0;
    const int32_t prev = in.prev[i];
    const int32_t term1 = in.term1[i];
    const bool seen = (in.recv[i] != 0 || in.reject_term[i] != 0) && back;
    higher |= seen && term1 > l_term;
    max_ack = max(max_ack, seen ? term1 : 0);
    const bool success = match && back;
    l_match[p] = in.l_match[i];
    l_next[p] = in.l_next[i];
    if (success) {
      l_match[p] = max(l_match[p], in.entries_sent[i] != 0 ? in.upto[i] : prev);
      l_next[p] = l_match[p] + 1;
    }
    if (in.ok_term[i] != 0 && !match && back) {
      const int32_t last = in.last_index[i];
      const int32_t hint = prev <= last ? prev - 1 : last;
      l_next[p] = max(min(prev, hint + 1), 1);
    }
    const bool self = p == ld;
    const bool member = !Masked || ((members >> p) & 1u);
    match_full[p] = member ? (self ? l_last : l_match[p]) : INT32_MIN;
    acked += (success || self) && member;
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const size_t i = static_cast<size_t>(g) * P + p;
    out.l_match[i] = l_match[p];
    out.l_next[i] = l_next[p];
  }
  const bool stale = active && higher;
  const bool sound = active && !stale;
  // The commit candidate and its term: one read of the leader's ring, masked
  // by the live window (idx in [1, l_last] and within L of l_last).
  const int32_t cand = quorum::kth_select<P>(match_full, quorum);
  const bool live = cand >= 1 && cand <= l_last && cand > l_last - L;
  const int32_t cand_term =
      live ? in.l_log_term[g * in.log_row_stride +
                           quorum::floormod(cand - 1, L)]
           : 0;
  const bool advance = sound && cand > l_commit && cand_term == l_term;
  out.leader_stale[g] = stale;
  out.lease[g] = sound && acked >= quorum;
  out.max_ack_term[g] = max_ack;
  out.l_commit[g] = advance ? cand : l_commit;
}

inline int blocks_for(int G, int groups_per_block) {
  return (G + groups_per_block - 1) / groups_per_block;
}

// Groups per block of admit_submits: kAdmitGroups, or fewer so that the
// staged rows (5 bytes a slot) fit the 48 KB a block may take without
// opting in to more.
constexpr int kAdmitGroups = 128;
constexpr int kSharedBytes = 48 * 1024;

inline int admit_groups(int S) {
  const int fit = kSharedBytes / (5 * S) / 32 * 32;
  return min(kAdmitGroups, fit);
}

template <int P>
void admit(const int32_t* applied, const int32_t* view, const int32_t* lead,
           const uint8_t* accept_ok, const uint8_t* valid,
           const int32_t* l_last, uint8_t* accepted, int32_t* assigned,
           int64_t* slot, int32_t* l_last_out, int G, int S, int quorum,
           int L, cudaStream_t s) {
  const int groups = admit_groups(S);
  const dim3 grid(blocks_for(G, groups)), block(kStageThreads * groups);
  if (view == nullptr)
    admit_submits_kernel<P, false><<<grid, block, 5 * S * groups, s>>>(
        applied, view, lead, accept_ok, valid, l_last, accepted, assigned,
        slot, l_last_out, G, S, quorum, L);
  else
    admit_submits_kernel<P, true><<<grid, block, 5 * S * groups, s>>>(
        applied, view, lead, accept_ok, valid, l_last, accepted, assigned,
        slot, l_last_out, G, S, quorum, L);
}

template <int P>
void ack(const AckIn& in, const AckOut& out, int G, int quorum, int L,
         cudaStream_t s) {
  const dim3 grid(blocks_for(G, quorum::kThreads)), block(quorum::kThreads);
  if (in.view == nullptr)
    ack_commit_kernel<P, false><<<grid, block, 0, s>>>(in, out, G, quorum, L);
  else
    ack_commit_kernel<P, true><<<grid, block, 0, s>>>(in, out, G, quorum, L);
}

}  // namespace

// applied [G,P] i32, view [G,P] i32 or null (static membership), lead [G]
// i32, accept_ok [G] u8, valid [G,S] u8,
// l_last [G] i32 in; accepted [G,S] u8, assigned [G,S] i32, slot [G,S] i64,
// l_last_out [G] i32 out; all contiguous on the device. 1 <= P <= 8,
// 1 <= quorum <= P, 1 <= S <= 256, L >= 1, lead in [-1, P) (the wrapper
// checks all but the last, which is a value on the device; a lead outside
// that range selects lane 0).
extern "C" int admit_submits_launch(
    const void* applied, const void* view, const void* lead,
    const void* accept_ok,
    const void* valid, const void* l_last, void* accepted, void* assigned,
    void* slot, void* l_last_out, int G, int P, int S, int quorum, int L,
    void* stream) {
  if (G <= 0) return 0;
  if (S < 1 || admit_groups(S) < 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* ap = static_cast<const int32_t*>(applied);
  const auto* vw = static_cast<const int32_t*>(view);
  const auto* le = static_cast<const int32_t*>(lead);
  const auto* ok = static_cast<const uint8_t*>(accept_ok);
  const auto* va = static_cast<const uint8_t*>(valid);
  const auto* ll = static_cast<const int32_t*>(l_last);
  auto* ac = static_cast<uint8_t*>(accepted);
  auto* as = static_cast<int32_t*>(assigned);
  auto* sl = static_cast<int64_t*>(slot);
  auto* lo = static_cast<int32_t*>(l_last_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 1:
      admit<1>(ap, vw, le, ok, va, ll, ac, as, sl, lo, G, S, quorum, L, s);
      break;
    case 2:
      admit<2>(ap, vw, le, ok, va, ll, ac, as, sl, lo, G, S, quorum, L, s);
      break;
    case 3:
      admit<3>(ap, vw, le, ok, va, ll, ac, as, sl, lo, G, S, quorum, L, s);
      break;
    case 4:
      admit<4>(ap, vw, le, ok, va, ll, ac, as, sl, lo, G, S, quorum, L, s);
      break;
    case 5:
      admit<5>(ap, vw, le, ok, va, ll, ac, as, sl, lo, G, S, quorum, L, s);
      break;
    case 6:
      admit<6>(ap, vw, le, ok, va, ll, ac, as, sl, lo, G, S, quorum, L, s);
      break;
    case 7:
      admit<7>(ap, vw, le, ok, va, ll, ac, as, sl, lo, G, S, quorum, L, s);
      break;
    case 8:
      admit<8>(ap, vw, le, ok, va, ll, ac, as, sl, lo, G, S, quorum, L, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// recv, reject_term, del_back, match, entries_sent, ok_term [G,P] u8;
// upto, prev, term1, last_index, l_match, l_next [G,P] i32; lead [G] i32
// (-1 none); active [G] u8; l_term, l_last, l_commit [G] i32; l_log_term
// rows of L i32, ``log_row_stride`` elements apart; view [G,P] i32 or null
// (static membership). Out: l_match_out, l_next_out [G,P] i32;
// leader_stale, lease [G] u8; max_ack_term, l_commit_out [G] i32. All
// contiguous on the device but l_log_term, whose rows need only be dense.
// 1 <= P <= 8, 1 <= quorum <= P, L >= 1.
extern "C" int ack_commit_launch(
    const void* recv, const void* reject_term, const void* del_back,
    const void* match, const void* entries_sent, const void* ok_term,
    const void* upto, const void* prev, const void* term1,
    const void* last_index, const void* l_match, const void* l_next,
    const void* lead, const void* active, const void* l_term,
    const void* l_last, const void* l_commit, const void* l_log_term,
    long long log_row_stride, const void* view, void* l_match_out,
    void* l_next_out, void* leader_stale, void* lease, void* max_ack_term,
    void* l_commit_out,
    int G, int P, int quorum, int L, void* stream) {
  if (G <= 0) return 0;
  const auto u8 = [](const void* p) { return static_cast<const uint8_t*>(p); };
  const auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  const AckIn in{u8(recv),       u8(reject_term), u8(del_back), u8(match),
                 u8(entries_sent), u8(ok_term),   i32(upto),    i32(prev),
                 i32(term1),     i32(last_index), i32(l_match), i32(l_next),
                 i32(lead),      u8(active),      i32(l_term),  i32(l_last),
                 i32(l_commit),  i32(l_log_term), log_row_stride,
                 i32(view)};
  const AckOut out{static_cast<int32_t*>(l_match_out),
                   static_cast<int32_t*>(l_next_out),
                   static_cast<uint8_t*>(leader_stale),
                   static_cast<uint8_t*>(lease),
                   static_cast<int32_t*>(max_ack_term),
                   static_cast<int32_t*>(l_commit_out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 1: ack<1>(in, out, G, quorum, L, s); break;
    case 2: ack<2>(in, out, G, quorum, L, s); break;
    case 3: ack<3>(in, out, G, quorum, L, s); break;
    case 4: ack<4>(in, out, G, quorum, L, s); break;
    case 5: ack<5>(in, out, G, quorum, L, s); break;
    case 6: ack<6>(in, out, G, quorum, L, s); break;
    case 7: ack<7>(in, out, G, quorum, L, s); break;
    case 8: ack<8>(in, out, G, quorum, L, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
