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
// What bounds them on an H100: at the widths most paths run, not bytes
// but latency and the share of the card a call fills. At the counter
// bench's shape (G=10,000, P=3, S=16, L=64) admit_submits reads
// G*(4P + 4 + 1 + S + 4) = 370,000 bytes and writes G*(S + 4S + 8S + 4) =
// 2,120,000 (0.74 us at 3.35 TB/s); ack_commit reads G*(6P + 24P + 17) =
// 1,070,000 bytes plus one 4-byte term per group whose commit candidate
// lies in the ring, and writes G*(8P + 10) = 340,000 (about 0.43 us). Both
// sets of inputs stay in the 50 MB L2 between calls, and an empty kernel
// takes about 1 us in a CUDA graph. At the mixed bench's G=100,000, P=5
// the bytes bind (7.7 and 6.6 us). The rank-select is 2*P^2 integer
// compares a group, far below the card's rate. So the design keeps
// everything between the inputs and the outputs out of device memory,
// makes one memory round trip before the compute where latency binds
// (every input load of a group issued before anything that depends on
// one; in ack_commit the commit candidate's ring term is the only
// dependent load), moves only the bytes it needs where bandwidth binds,
// and spreads a call over enough threads to put blocks on every SM at
// G = 10,000 (block_threads: the largest block of 256 down to 32 threads
// that still gives every SM two). The choices below were made by
// ab_quorum_kernels.py on an H100 (PERF.md, Findings):
//
// - phase 1, P <= 8 (admit_submits_slots_kernel): a tile of W threads owns
//   a group (W a power of two up to a warp, so a tile never straddles two
//   warps), each thread V consecutive submit slots, W = S / V rounded up
//   (wider rows take several steps of 32 * V slots). V = 4 where the [G,S]
//   rows allow 16-byte stores (S a multiple of 4, the buffers aligned:
//   valid and accepted move 4 bytes a thread, assigned one 16-byte store,
//   the int64 slot two) and the call is wide enough that four slots a
//   thread still fill every SM's thread slots (the mixed bench's 100,000
//   x 16); else V = 1, a slot a thread, four times the threads (the
//   counter bench's 10,000 x 16 and the server's and spi's S = 4 run
//   faster so; a misaligned `valid` view also lands here). The group's P
//   applied values are read by every thread of the tile as one broadcast
//   and ranked in registers with quorum::kth_select<P>; a ballot of each
//   bit of a thread's count of wanted slots (tile_sums) gives each slot
//   its log position, so the [G,S] rows (valid in; accepted, assigned and
//   slot out, 2.3 of the 2.5 MB at the counter shape) go straight between
//   registers and device memory, adjacent threads on adjacent bytes, with
//   no shared memory and no __syncthreads. Staging a block's rows through
//   shared memory with cp.async.bulk (TMA) and an mbarrier, in and out,
//   was slower at every shape measured and is not kept;
// - phase 3, P <= 8: a tile of 4 (P <= 4) or 8 threads a group, a thread a
//   peer (ack_commit_tile_kernel, below), while the call's tiles fit the
//   card's resident threads at once (G up to 67,584 at P <= 4 on an H100);
//   past that a thread a group: static, the first design's kernel
//   (ack_commit_kernel, each input loaded only where the ack reads it, so
//   the bytes the mixed bench's acks do not use stay unread), and under
//   dynamic membership ack_commit_members_kernel (every load first, the
//   leader's view word picked in registers), each the faster at 100,000
//   groups;
// - past 8 peers, every quorum kernel runs a tile a group: W = 16 up to 16
//   peers, 32 above, thread `lane` owning peer `lane` (past 32 peers, lane
//   + 32, lane + 64, ... as well). Each thread loads its own elements of
//   the [G,P] arrays, so a tile's loads are one contiguous row and a
//   warp's are coalesced; the group's scalars (lead, accept_ok, active,
//   the leader's term, last and commit index) are one address every
//   thread of the tile reads, a broadcast. In ack_commit the stale test,
//   the lease count and the highest ack term are ballots and a shuffle
//   butterfly over the tile (whole-warp instructions, where a
//   __reduce_*_sync over masks that differ between a warp's tiles is
//   not), and the rank-select is quorum::tile_kth_select, where each lane
//   counts its own value's rank with shuffles and a ballot names the lane
//   that holds the result. Nothing the select reads passes through
//   memory: ack_commit writes matchIndex and nextIndex once and never
//   reads them back. Past 32 peers a thread holds ceil(P/32) lanes, and
//   the select computes each again from the inputs (the applied row; an
//   ack's matchIndex from its six inputs) rather than from anything the
//   launch wrote. A tile past the last group reads the last group's
//   inputs and stores nothing, so every warp stays converged;
// - bool tensors are one byte of 0/1 and are read and written as uint8_t;
// - phase 1's positions are summed as uint32 and read back as int32, the
//   wrapping int32 arithmetic of the plain code without signed overflow;
//   every `%` of the plain code is quorum::floormod.
//
// Dynamic membership (Config.dynamic_membership) changes the tally itself:
// the reference takes kth_largest_masked with a per-group quorum at
// copycat_tpu/ops/consensus.py:643 and :829, and counts the lease's acks over
// member lanes only (:826-828). Both kernels take an optional `view` [G,P]
// int32, each lane's active-config bitmask. Where it is given (the `Masked`
// instantiation), the kernel takes the leader lane's word from the view
// row it loads beside `lead` (a thread that holds a group's P <= 8 lanes
// loads all P words and picks the leader's in registers; on a tile, each
// thread loads its own lane's word, handed to the tile by the leader
// lane's thread), so no load waits for `lead`: the quorum is
// popc(word) / 2 + 1, a lane outside the word enters the rank-select as
// INT32_MIN (as kth_largest_masked does), and in ack_commit only member
// lanes count towards the lease.
// Where it is null the static instantiation runs: `Masked` is a template
// flag, so the static path carries no test of it. A view names at most 32
// lanes, so a masked tile holds one lane a thread.
//
// `lead` comes in unclamped (-1 for a leaderless group). The leader's
// applied_index is lane max(lead, 0)'s, as the plain code's _peer_view
// reads it; the self-lane test compares with the unclamped value, so a
// leaderless group has no self lane. Leaderless groups get every output,
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

// ---- tiles of a run-time width ---------------------------------------------

// This thread's tile of 2^log_w threads (blockDim.x a multiple of 32): its
// lane, the tile's lanes as a warp mask, and the lanes below its own.
struct Tile {
  int lane;
  uint32_t mask, below;
};

__device__ __forceinline__ Tile tile_of(int log_w) {
  const int w = 1 << log_w;
  const int warp_lane = threadIdx.x & 31;
  const int lane = warp_lane & (w - 1);
  const int first = warp_lane - lane;
  const uint32_t ones = w == 32 ? ~0u : (1u << w) - 1;
  return {lane, ones << first, ((1u << lane) - 1) << first};
}

// ---- phase 1, P <= 8: V submit slots a thread ------------------------------

// Bit j set where slot s + j of the row at `row` is valid, for the V slots
// s.. of this thread (none past S; with V = 4, S is a multiple of 4 and
// the row 4-byte aligned).
template <int V>
__device__ __forceinline__ uint32_t slot_flags(const uint8_t* valid,
                                               size_t row, int s, int S) {
  if (s >= S) return 0;
  if constexpr (V == 1) {
    return valid[row + s] != 0;
  } else {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(valid + row + s);
    return ((x & 0xffu) != 0) | (((x >> 8) & 0xffu) != 0) << 1 |
           (((x >> 16) & 0xffu) != 0) << 2 | ((x >> 24) != 0) << 3;
  }
}

// The sum over this thread's tile of a count of at most 2^bits - 1 per
// thread, and the sum over the tile's lanes below this one: a ballot of each
// bit of the count. Every thread of the warp calls it together; a ballot
// over the whole warp is one instruction, where a reduction over masks
// that differ between the warp's tiles is not.
template <int Bits>
__device__ __forceinline__ void tile_sums(const Tile& t, uint32_t count,
                                          uint32_t& below, uint32_t& total) {
  below = total = 0;
#pragma unroll
  for (int b = 0; b < Bits; ++b) {
    const uint32_t bits = __ballot_sync(~0u, (count >> b) & 1u);
    below += __popc(bits & t.below) << b;
    total += __popc(bits & t.mask) << b;
  }
}

// One tile of 2^log_w threads owns a group, thread `lane` slots lane * V
// .. lane * V + V - 1 of each step of V << log_w slots. The slots are
// admitted a step at a time: the wanted slots of lower lanes (a ballot of
// each bit of this thread's count) give each of its slots its log
// position, and the tile's sum of the accepted moves l_last.
template <int P, int V, bool Masked>
__global__ void admit_submits_slots_kernel(
    const int32_t* __restrict__ applied, const int32_t* __restrict__ view,
    const int32_t* __restrict__ lead,
    const uint8_t* __restrict__ accept_ok, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ l_last, uint8_t* __restrict__ accepted,
    int32_t* __restrict__ assigned, int64_t* __restrict__ slot,
    int32_t* __restrict__ l_last_out, int G, int S, int quorum, int L,
    int log_w) {
  static_assert(V == 1 || V == 4, "a thread takes 1 or 4 slots");
  const Tile t = tile_of(log_w);
  const int g = static_cast<int>(
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> log_w);
  const bool owner = g < G;
  const int gr = min(g, G - 1);
  const size_t row = static_cast<size_t>(gr) * S;
  const int step = V << log_w;

  // Every load first, none waiting for another.
  int32_t v[P];
  uint32_t w[Masked ? P : 1];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    v[p] = applied[static_cast<size_t>(gr) * P + p];
    if constexpr (Masked)
      w[p] = static_cast<uint32_t>(view[static_cast<size_t>(gr) * P + p]);
  }
  const int32_t ld = max(lead[gr], 0);
  const bool ok = accept_ok[gr] != 0;
  const int32_t last = l_last[gr];
  const uint32_t first = slot_flags<V>(valid, row, t.lane * V, S);

  // Backpressure: the ring never overwrites an entry the leader or a
  // quorum-th replica still has to apply.
  int32_t l_applied = v[0];
  uint32_t members = 0;
  if constexpr (Masked) members = w[0];
#pragma unroll
  for (int p = 1; p < P; ++p)
    if (p == ld) {
      l_applied = v[p];
      if constexpr (Masked) members = w[p];
    }
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
  const int32_t allowed = static_cast<int32_t>(
      static_cast<uint32_t>(min(l_applied, floor_q)) + L);

  uint32_t pos = static_cast<uint32_t>(last);
  int n_acc = 0;
  for (int s0 = 0; s0 < S; s0 += step) {
    const int s = s0 + t.lane * V;
    const uint32_t flags =
        ok ? (s0 == 0 ? first : slot_flags<V>(valid, row, s, S)) : 0u;
    // the wanted slots of the tile's lower lanes, and of the whole tile
    constexpr int kBits = V == 1 ? 1 : 3;     // a count of 0..V
    uint32_t before, total;
    tile_sums<kBits>(t, __popc(flags), before, total);
    uint32_t at = pos + before;
    uint32_t acc = 0;
    int32_t at_pos[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const uint32_t want = (flags >> j) & 1u;
      at += want;
      at_pos[j] = static_cast<int32_t>(at);
      acc |= (want && at_pos[j] <= allowed) << j;
    }
    if (owner && s < S) {
      const size_t i = row + s;
      const auto slot_of = [&](int j) -> int64_t {
        return (acc >> j) & 1u
                   ? quorum::floormod(static_cast<int32_t>(
                                          static_cast<uint32_t>(at_pos[j]) -
                                          1u),
                                      L)
                   : L;
      };
      const auto pos_of = [&](int j) {
        return (acc >> j) & 1u ? at_pos[j] : 0;
      };
      if constexpr (V == 1) {
        accepted[i] = acc;
        assigned[i] = pos_of(0);
        slot[i] = slot_of(0);
      } else {
        *reinterpret_cast<uint32_t*>(accepted + i) =
            (acc & 1u) | (acc & 2u) << 7 | (acc & 4u) << 14 | (acc & 8u) << 21;
        *reinterpret_cast<int4*>(assigned + i) =
            make_int4(pos_of(0), pos_of(1), pos_of(2), pos_of(3));
        *reinterpret_cast<longlong2*>(slot + i) =
            make_longlong2(slot_of(0), slot_of(1));
        *reinterpret_cast<longlong2*>(slot + i + 2) =
            make_longlong2(slot_of(2), slot_of(3));
      }
    }
    pos += total;
    uint32_t unused, accepted_here;
    tile_sums<kBits>(t, __popc(acc), unused, accepted_here);
    n_acc += static_cast<int>(accepted_here);
  }
  if (owner && t.lane == 0)
    l_last_out[g] = static_cast<int32_t>(static_cast<uint32_t>(last) + n_acc);
}

// ---- phase 3 ---------------------------------------------------------------

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

// One lane's ack: the leader's new matchIndex and nextIndex for it, and
// what it tells the leader.
struct LaneAck {
  int32_t match, next, term1;
  bool seen, success;
};

// All twelve loads issued before any test: one round trip, for a tile (a
// lane a thread) and for a thread that holds a group's lanes.
__device__ __forceinline__ LaneAck lane_ack(const AckIn& in, size_t i) {
  const bool recv = in.recv[i] != 0, reject = in.reject_term[i] != 0;
  const bool back = in.del_back[i] != 0, match = in.match[i] != 0;
  const bool sent = in.entries_sent[i] != 0, ok_term = in.ok_term[i] != 0;
  const int32_t upto = in.upto[i], prev = in.prev[i];
  const int32_t last = in.last_index[i];
  LaneAck a;
  a.term1 = in.term1[i];
  a.match = in.l_match[i];
  a.next = in.l_next[i];
  a.seen = (recv || reject) && back;
  a.success = match && back;
  if (a.success) {
    a.match = max(a.match, sent ? upto : prev);
    a.next = a.match + 1;
  }
  if (ok_term && !match && back) {
    const int32_t hint = prev <= last ? prev - 1 : last;
    a.next = max(min(prev, hint + 1), 1);
  }
  return a;
}

// The same ack, each input loaded only where the plain expression reads it
// (reject_term where recv is 0, entries_sent and upto where the ack
// matched, last_index where it failed on the term): a call bound by
// bandwidth moves only the bytes its acks use. On the mixed bench's step
// (100,000 x 5) a thread a group took 0.009777 ms so, against 0.010308 with
// lane_ack's loads all first (ab_quorum_kernels.py, H100 80GB HBM3 at
// 700 W; PERF.md, Findings).
__device__ __forceinline__ LaneAck lane_ack_lazy(const AckIn& in, size_t i) {
  const bool back = in.del_back[i] != 0;
  const bool match = in.match[i] != 0;
  const int32_t prev = in.prev[i];
  LaneAck a;
  a.term1 = in.term1[i];
  a.seen = (in.recv[i] != 0 || in.reject_term[i] != 0) && back;
  a.success = match && back;
  a.match = in.l_match[i];
  a.next = in.l_next[i];
  if (a.success) {
    a.match = max(a.match, in.entries_sent[i] != 0 ? in.upto[i] : prev);
    a.next = a.match + 1;
  }
  if (in.ok_term[i] != 0 && !match && back) {
    const int32_t last = in.last_index[i];
    const int32_t hint = prev <= last ? prev - 1 : last;
    a.next = max(min(prev, hint + 1), 1);
  }
  return a;
}

// ---- phase 3, P <= 8 on calls too wide for tiles: a thread a group --------

// Static membership: thread g owns group g, its P lanes in registers (one
// instantiation for each P, the lane loops unrolled), each lane's ack
// loaded lazily (lane_ack_lazy), the tally by quorum::kth_select<P>. `np`
// (== P) is not read: it keeps the first design's parameter layout, with
// which this source compiles to that kernel's machine code instruction for
// instruction. Without it ptxas orders the same loads otherwise, and the
// mixed bench's call (100,000 x 5) read 1.5-3.7% slower (PERF.md,
// Findings).
template <int P>
__global__ void ack_commit_kernel(const AckIn in, const AckOut out, int G,
                                  int np, int quorum, int L) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const int32_t ld = in.lead[g];
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
    const LaneAck a = lane_ack_lazy(in, static_cast<size_t>(g) * P + p);
    higher |= a.seen && a.term1 > l_term;
    max_ack = max(max_ack, a.seen ? a.term1 : 0);
    l_match[p] = a.match;
    l_next[p] = a.next;
    const bool self = p == ld;
    match_full[p] = self ? l_last : a.match;
    acked += a.success || self;
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const size_t i = static_cast<size_t>(g) * P + p;
    out.l_match[i] = l_match[p];
    out.l_next[i] = l_next[p];
  }
  const int32_t cand = quorum::kth_select<P>(match_full, quorum);
  const bool stale = active && higher;
  const bool sound = active && !stale;
  // The commit candidate and its term: one read of the leader's ring, masked
  // by the live window (idx in [1, l_last] and within L of l_last).
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

// Dynamic membership: thread g loads its group's P view words beside
// `lead` and all twelve inputs of each lane before any test (the leader's
// word picked in registers, so no load waits for `lead`), then takes the
// member acks and the masked tally on registers.
template <int P>
__global__ void ack_commit_members_kernel(const AckIn in, const AckOut out,
                                          int G, int L) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const size_t row = static_cast<size_t>(g) * P;
  uint32_t w[P];
#pragma unroll
  for (int p = 0; p < P; ++p)
    w[p] = static_cast<uint32_t>(in.view[row + p]);
  const int32_t ld = in.lead[g];
  const bool active = in.active[g] != 0;
  const int32_t l_term = in.l_term[g];
  const int32_t l_last = in.l_last[g];
  const int32_t l_commit = in.l_commit[g];
  LaneAck a[P];
#pragma unroll
  for (int p = 0; p < P; ++p) a[p] = lane_ack(in, row + p);
  uint32_t members = w[0];
#pragma unroll
  for (int p = 1; p < P; ++p)
    if (p == ld) members = w[p];
  const int k = quorum::of_members(members);
  bool higher = false;
  int32_t max_ack = INT32_MIN;  // a max over P lanes, each term1 or 0
  int acked = 0;
  int32_t match_full[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    higher |= a[p].seen && a[p].term1 > l_term;
    max_ack = max(max_ack, a[p].seen ? a[p].term1 : 0);
    const bool self = p == ld;
    const bool member = (members >> p) & 1u;
    match_full[p] = member ? (self ? l_last : a[p].match) : INT32_MIN;
    acked += (a[p].success || self) && member;
    out.l_match[row + p] = a[p].match;
    out.l_next[row + p] = a[p].next;
  }
  const int32_t cand = quorum::kth_select<P>(match_full, k);
  const bool stale = active && higher;
  const bool sound = active && !stale;
  const bool live = cand >= 1 && cand <= l_last && cand > l_last - L;
  const int32_t cand_term =
      live ? in.l_log_term[g * in.log_row_stride +
                           quorum::floormod(cand - 1, L)]
           : 0;
  const bool advance = sound && cand > l_commit && cand_term == l_term;
  out.leader_stale[g] = stale;
  out.lease[g] = sound && acked >= k;
  out.max_ack_term[g] = max_ack;
  out.l_commit[g] = advance ? cand : l_commit;
}

// ---- warp tiles: a thread a peer (phase 3 at every P, phase 1 past 8) ------

// W threads own a group (W = 4, 8, 16 or 32, quorum.cuh's tiles), thread
// `lane` of the tile peers lane + j*W, j < chunks: Chunks is 1 as a
// constant (P <= W, the peer's value in a register), or 0 for ceil(P/32)
// at run time (P > 32, W = 32, static membership only).

// Phase 1 past 8 peers. Thread `lane` of the tile also owns submit slots
// lane, lane + W, ...: a tile reads and writes its group's [S] rows as
// contiguous segments, so a warp's accesses to the [G,S] arrays are
// coalesced without staging them through shared memory (the wide serves'
// S = 4 is one step). The slots are admitted W at a time: a ballot of the
// wanted slots gives each its log position (the prefix count), a second
// ballot the accepted.
template <int W, int Chunks, bool Masked>
__global__ void admit_submits_tile_kernel(
    const int32_t* __restrict__ applied, const int32_t* __restrict__ view,
    const int32_t* __restrict__ lead,
    const uint8_t* __restrict__ accept_ok, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ l_last, uint8_t* __restrict__ accepted,
    int32_t* __restrict__ assigned, int64_t* __restrict__ slot,
    int32_t* __restrict__ l_last_out, int G, int np, int S, int quorum,
    int L) {
  static_assert(!Masked || Chunks == 1, "a view names at most 32 lanes");
  const int lane = quorum::tile_lane<W>();
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) / W;
  const bool owner = g < G;
  const int gr = min(g, G - 1);
  const int32_t* row = applied + static_cast<size_t>(gr) * np;
  const size_t srow = static_cast<size_t>(gr) * S;

  // Every load first, none waiting for another: with one lane a thread,
  // the leader's applied index and view word come from the leader lane's
  // thread by a shuffle rather than by a second, dependent load.
  const bool in_row = lane < np;
  const int32_t ld = max(lead[gr], 0);
  const bool ok = owner && accept_ok[gr] != 0;
  const int32_t last = l_last[gr];
  const bool first = lane < S && valid[srow + lane] != 0;  // slots 0..W-1
  int32_t mine = 0;         // with Chunks == 1, this lane's applied index
  uint32_t word = 0;        // and view word
  if constexpr (Chunks == 1) {
    if (in_row) mine = row[lane];
    if constexpr (Masked)
      if (in_row) word = view[static_cast<size_t>(gr) * np + lane];
  }
  const int lane_ld = ld < np ? ld : 0;
  const int32_t l_applied = Chunks == 1 ? __shfl_sync(~0u, mine, lane_ld, W)
                                        : row[lane_ld];
  int k = quorum;
  if constexpr (Masked) {
    const uint32_t members = __shfl_sync(~0u, word, ld, W);
    k = quorum::of_members(members);
    if (!((members >> lane) & 1u)) mine = INT32_MIN;
  }
  if (!in_row) mine = INT32_MIN;

  // Backpressure: the ring never overwrites an entry the leader or a
  // quorum-th replica still has to apply. Past 32 peers each of this
  // thread's lanes is read again from the applied row.
  const int chunks = Chunks > 0 ? Chunks : (np + W - 1) / W;
  const int32_t floor_q = quorum::tile_kth_select<W>(
      [&](int j) {
        const int p = lane + j * W;
        return Chunks == 1 ? mine : p < np ? row[p] : INT32_MIN;
      },
      chunks, np, k);
  const int32_t allowed = min(l_applied, floor_q) + L;
  const uint32_t below = (1u << lane) - 1;
  int32_t pos = last;
  int32_t n_acc = 0;
  for (int s0 = 0; s0 < S; s0 += W) {
    const int s = s0 + lane;
    const bool want =
        ok && s < S && (s0 == 0 ? first : valid[srow + s] != 0);
    const uint32_t wants = quorum::tile_ballot<W>(want);
    const int32_t at_pos = pos + __popc(wants & below) + 1;
    const bool acc = want && at_pos <= allowed;
    if (owner && s < S) {
      accepted[srow + s] = acc;
      assigned[srow + s] = acc ? at_pos : 0;
      slot[srow + s] = acc ? quorum::floormod(at_pos - 1, L) : L;
    }
    pos += __popc(wants);
    n_acc += __popc(quorum::tile_ballot<W>(acc));
  }
  if (owner && lane == 0) l_last_out[g] = last + n_acc;
}

// Phase 3. Each thread takes its lanes' acks in registers and writes their
// matchIndex and nextIndex once; the tile reduces the stale test, the ack
// count and the highest ack term with warp reductions and selects the
// commit candidate from its registers; the tile's first thread reads the
// candidate's term and writes the [G] outputs.
template <int W, int Chunks, bool Masked>
__global__ void ack_commit_tile_kernel(const AckIn in, const AckOut out,
                                       int G, int np, int quorum, int L) {
  const int lane = quorum::tile_lane<W>();
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) / W;
  const bool owner = g < G;
  const int gr = min(g, G - 1);
  const size_t row = static_cast<size_t>(gr) * np;
  static_assert(!Masked || Chunks == 1, "a view names at most 32 lanes");
  const int32_t ld = in.lead[gr];
  uint32_t members = ~0u;
  if constexpr (Masked) {
    // each thread loads its own lane's word, the leader lane's thread
    // hands its word to the tile: no load waits for `lead`
    const uint32_t word =
        lane < np ? static_cast<uint32_t>(in.view[row + lane]) : 0u;
    members = __shfl_sync(~0u, word, max(ld, 0), W);
    quorum = quorum::of_members(members);
  }
  const bool active = in.active[gr] != 0;
  const int32_t l_term = in.l_term[gr];
  const int32_t l_last = in.l_last[gr];
  const int32_t l_commit = in.l_commit[gr];
  const auto member = [&](int p) {
    return !Masked || ((members >> p) & 1u);
  };
  bool higher = false;
  int32_t max_ack = INT32_MIN;  // a max over the lanes, each term1 or 0
  int acked = 0;
  int32_t mine = INT32_MIN;     // this lane's matchIndex for the select
  const int chunks = Chunks > 0 ? Chunks : (np + W - 1) / W;
  for (int j = 0; j < chunks; ++j) {
    const int p = lane + j * W;
    if (p < np) {
      const LaneAck a = lane_ack(in, row + p);
      higher |= a.seen && a.term1 > l_term;
      max_ack = max(max_ack, a.seen ? a.term1 : 0);
      if (owner) {
        out.l_match[row + p] = a.match;
        out.l_next[row + p] = a.next;
      }
      acked += (a.success || p == ld) && member(p);
      mine = member(p) ? (p == ld ? l_last : a.match) : INT32_MIN;
    }
  }
  // The tile's reductions by ballots and a shuffle butterfly: whole-warp
  // instructions, where a __reduce_*_sync over masks that differ between
  // the warp's tiles is not one.
  const uint32_t tile = quorum::tile_mask<W>();
  higher = (__ballot_sync(~0u, higher) & tile) != 0;
  if constexpr (Chunks == 1)
    acked = __popc(__ballot_sync(~0u, acked) & tile);
  else
    acked = static_cast<int>(__reduce_add_sync(tile, acked));
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1)
    max_ack = max(max_ack, __shfl_xor_sync(~0u, max_ack, o, W));
  // Past 32 peers, each of this lane's values again from the inputs.
  const auto at = [&](int j) {
    const int p = lane + j * W;
    if (p >= np || !member(p)) return INT32_MIN;
    return p == ld ? l_last : lane_ack(in, row + p).match;
  };
  const int32_t cand = quorum::tile_kth_select<W>(
      [&](int j) { return Chunks == 1 ? mine : at(j); }, chunks, np,
      quorum);
  if (!owner || lane != 0) return;
  const bool stale = active && higher;
  const bool sound = active && !stale;
  // The commit candidate and its term: one read of the leader's ring, masked
  // by the live window (idx in [1, l_last] and within L of l_last).
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

// ---- launchers -------------------------------------------------------------

// The current card's SMs and the threads each holds at once (an H100: 132
// and 2,048), asked once per device: into `c`, or the runtime's error.
struct Card {
  int sms = 0, threads_per_sm = 0;
  int64_t resident() const {
    return static_cast<int64_t>(sms) * threads_per_sm;
  }
};

cudaError_t card(Card& c) {
  static Card cards[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  Card& known = cards[dev & 63];
  if (known.sms == 0) {
    Card asked;
    e = cudaDeviceGetAttribute(&asked.sms, cudaDevAttrMultiProcessorCount,
                               dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&asked.threads_per_sm,
                                 cudaDevAttrMaxThreadsPerMultiProcessor, dev);
    if (e != cudaSuccess) return e;
    known = asked;
  }
  c = known;
  return cudaSuccess;
}

// Threads a block for a launch of `threads` threads: the largest of 256,
// 128, 64 and 32 that still gives every SM two blocks, so a call of 10,000
// groups spreads over the whole card.
int block_threads(int64_t threads, const Card& c) {
  const int64_t per = threads / (2 * static_cast<int64_t>(c.sms));
  return per >= 256 ? 256 : per >= 128 ? 128 : per >= 64 ? 64 : 32;
}

dim3 grid_for(int64_t threads, int block) {
  return dim3(static_cast<unsigned>((threads + block - 1) / block));
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Phase 1, P <= 8: four slots a thread where every [G,S] row allows it and
// the call is wide enough that four a thread still fill every SM's thread
// slots (the mixed bench's 100,000 x 16 slots); below that (the counter
// bench's 10,000 x 16, the server's and spi's S = 4), one slot a thread, so
// a call spreads over four times the threads.
template <int P>
void admit(const int32_t* applied, const int32_t* view, const int32_t* lead,
           const uint8_t* accept_ok, const uint8_t* valid,
           const int32_t* l_last, uint8_t* accepted, int32_t* assigned,
           int64_t* slot, int32_t* l_last_out, int G, int S, int quorum,
           int L, const Card& c, cudaStream_t s) {
  const bool quad = S % 4 == 0 &&
                    static_cast<int64_t>(G) * (S / 4) >= c.resident() &&
                    aligned(valid, 4) && aligned(accepted, 4) &&
                    aligned(assigned, 16) && aligned(slot, 16);
  const int per = quad ? 4 : 1;
  int log_w = 0;
  while (log_w < 5 && (per << log_w) < S) ++log_w;
  const int64_t threads = static_cast<int64_t>(G) << log_w;
  const int block = block_threads(threads, c);
  const dim3 grid = grid_for(threads, block);
#define COPYCAT_ADMIT(V, M)                                                 \
  admit_submits_slots_kernel<P, V, M><<<grid, block, 0, s>>>(              \
      applied, view, lead, accept_ok, valid, l_last, accepted, assigned,    \
      slot, l_last_out, G, S, quorum, L, log_w)
  if (view == nullptr) {
    if (quad) COPYCAT_ADMIT(4, false);
    else COPYCAT_ADMIT(1, false);
  } else {
    if (quad) COPYCAT_ADMIT(4, true);
    else COPYCAT_ADMIT(1, true);
  }
#undef COPYCAT_ADMIT
}

// Past 8 peers: W = 16 up to 16 peers, 32 above; past 32 peers (static
// membership only, as lanes_ok has it) a thread holds ceil(P/32). A block
// holds kTileThreads / W groups.
constexpr int kTileThreads = 256;

template <int W, int Chunks>
void admit_tile(const int32_t* applied, const int32_t* view,
                const int32_t* lead, const uint8_t* accept_ok,
                const uint8_t* valid, const int32_t* l_last,
                uint8_t* accepted, int32_t* assigned, int64_t* slot,
                int32_t* l_last_out, int G, int P, int S, int quorum, int L,
                cudaStream_t s) {
  const dim3 grid = grid_for(static_cast<int64_t>(G) * W, kTileThreads);
  if (view == nullptr)
    admit_submits_tile_kernel<W, Chunks, false><<<grid, kTileThreads, 0, s>>>(
        applied, view, lead, accept_ok, valid, l_last, accepted, assigned,
        slot, l_last_out, G, P, S, quorum, L);
  else if constexpr (Chunks == 1)
    admit_submits_tile_kernel<W, Chunks, true><<<grid, kTileThreads, 0, s>>>(
        applied, view, lead, accept_ok, valid, l_last, accepted, assigned,
        slot, l_last_out, G, P, S, quorum, L);
}

// Phase 3 on tiles: W = 4 and 8 (P <= 8) in blocks that fill the card,
// W = 16 and 32 in blocks of kTileThreads.
template <int W, int Chunks>
void ack_tile(const AckIn& in, const AckOut& out, int G, int P, int quorum,
              int L, const Card& c, cudaStream_t s) {
  const int64_t threads = static_cast<int64_t>(G) * W;
  const int block = W <= 8 ? block_threads(threads, c) : kTileThreads;
  const dim3 grid = grid_for(threads, block);
  if (in.view == nullptr)
    ack_commit_tile_kernel<W, Chunks, false><<<grid, block, 0, s>>>(
        in, out, G, P, quorum, L);
  else if constexpr (Chunks == 1)
    ack_commit_tile_kernel<W, Chunks, true><<<grid, block, 0, s>>>(
        in, out, G, P, quorum, L);
}

// Phase 3, P <= 8: a tile of 4 or 8 threads a group while the call's
// tiles all fit the card at once (W * G within its resident threads);
// past that a thread a group, in blocks of quorum::kThreads.
template <int P>
void ack(const AckIn& in, const AckOut& out, int G, int quorum, int L,
         const Card& c, cudaStream_t s) {
  constexpr int W = P <= 4 ? 4 : 8;
  if (static_cast<int64_t>(G) * W <= c.resident()) {
    ack_tile<W, 1>(in, out, G, P, quorum, L, c, s);
    return;
  }
  const dim3 grid = grid_for(G, quorum::kThreads);
  if (in.view == nullptr)
    ack_commit_kernel<P><<<grid, quorum::kThreads, 0, s>>>(in, out, G, P,
                                                          quorum, L);
  else
    ack_commit_members_kernel<P><<<grid, quorum::kThreads, 0, s>>>(in, out,
                                                                  G, L);
}

// Whether (P, view) is a shape the kernels take: any P >= 1, and no more
// lanes than a membership word names when a view is given.
inline bool lanes_ok(int P, const void* view) {
  return P >= 1 && (view == nullptr || P <= quorum::kMaxMemberLanes);
}

}  // namespace

// applied [G,P] i32, view [G,P] i32 or null (static membership), lead [G]
// i32, accept_ok [G] u8, valid [G,S] u8,
// l_last [G] i32 in; accepted [G,S] u8, assigned [G,S] i32, slot [G,S] i64,
// l_last_out [G] i32 out; all contiguous on the device. P >= 1 (P <= 32
// with a view), 1 <= quorum <= P, S >= 1, L >= 1, lead in [-1, P) (the
// wrapper checks all but the last, which is a value on the device; a lead
// outside that range selects lane 0).
extern "C" int admit_submits_launch(
    const void* applied, const void* view, const void* lead,
    const void* accept_ok,
    const void* valid, const void* l_last, void* accepted, void* assigned,
    void* slot, void* l_last_out, int G, int P, int S, int quorum, int L,
    void* stream) {
  if (G <= 0) return 0;
  if (S < 1 || !lanes_ok(P, view))
    return static_cast<int>(cudaErrorInvalidValue);
  Card c;
  if (const cudaError_t e = card(c); e != cudaSuccess)
    return static_cast<int>(e);
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
#define COPYCAT_CASE(N)                                                     \
  case N:                                                                   \
    admit<N>(ap, vw, le, ok, va, ll, ac, as, sl, lo, G, S, quorum, L, c,    \
             s);                                                            \
    break;
    COPYCAT_CASE(1) COPYCAT_CASE(2) COPYCAT_CASE(3) COPYCAT_CASE(4)
    COPYCAT_CASE(5) COPYCAT_CASE(6) COPYCAT_CASE(7) COPYCAT_CASE(8)
#undef COPYCAT_CASE
    default:
      if (P <= 16)
        admit_tile<16, 1>(ap, vw, le, ok, va, ll, ac, as, sl, lo, G, P, S,
                          quorum, L, s);
      else if (P <= 32)
        admit_tile<32, 1>(ap, vw, le, ok, va, ll, ac, as, sl, lo, G, P, S,
                          quorum, L, s);
      else
        admit_tile<32, 0>(ap, vw, le, ok, va, ll, ac, as, sl, lo, G, P, S,
                          quorum, L, s);
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
// P >= 1 (P <= 32 with a view), 1 <= quorum <= P, L >= 1.
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
  if (!lanes_ok(P, view)) return static_cast<int>(cudaErrorInvalidValue);
  Card c;
  if (const cudaError_t e = card(c); e != cudaSuccess)
    return static_cast<int>(e);
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
#define COPYCAT_CASE(N)                                                     \
  case N:                                                                   \
    ack<N>(in, out, G, quorum, L, c, s);                                    \
    break;
    COPYCAT_CASE(1) COPYCAT_CASE(2) COPYCAT_CASE(3) COPYCAT_CASE(4)
    COPYCAT_CASE(5) COPYCAT_CASE(6) COPYCAT_CASE(7) COPYCAT_CASE(8)
#undef COPYCAT_CASE
    default:
      if (P <= 16) ack_tile<16, 1>(in, out, G, P, quorum, L, c, s);
      else if (P <= 32) ack_tile<32, 1>(in, out, G, P, quorum, L, c, s);
      else ack_tile<32, 0>(in, out, G, P, quorum, L, c, s);
  }
  return static_cast<int>(cudaGetLastError());
}
