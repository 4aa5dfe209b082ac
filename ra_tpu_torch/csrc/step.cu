// The fused consensus step of the batch backend, with the quorum scan
// inlined: consensus_step_packed_scat (full width) and
// consensus_step_packed_sub_scat (active set).
//
// Counterpart of the JAX package's XLA-fused steps
// ra_tpu/ops/consensus.py::consensus_step_packed_scat (:693) and
// ::consensus_step_packed_sub_scat (:703), which reach the Pallas quorum
// kernel ra_tpu/ops/pallas_quorum.py::_quorum_kernel (:38) through the
// step. It computes exactly what the port's plain version computes
// (ops/consensus.py: consensus_step_packed_scat_plain and
// consensus_step_packed_sub_scat_plain, i.e. _apply_packed_scatters then
// consensus_step_impl), field for field:
//
//   1. the packed scatters: the a_* appended run of each group into its
//      term ring, last_index, last_term and unknown_lo/hi; the w_*
//      durable watermarks by max into written_index;
//   2. per group: classify the message, handle a higher term, decide the
//      AER, count votes and pre-votes, promote, update the leader's
//      match/next, run the quorum scan (quorum_net.cuh, on registers),
//      look up the term of the agreed index, commit;
//   3. the 17 EGRESS_FIELDS rows into one (17, S) int32 tensor.
//
// Design, four launches a step on both paths:
//   1. a memset of two [G] maps;
//   2. a pre-pass, one thread per scatter row, fills them: the packed row
//      of each group's appended run (atomicMax, so the last listed row
//      wins if a caller breaks the contract that a_gid ids are unique, as
//      JAX requires) and the max of its watermarks (atomicMax: duplicate
//      w_gid ids reduce by max);
//   3. one thread per ring slot (G*K threads, coalesced) writes every
//      group's scattered ring into the output; on the active set, thread
//      t < G also writes group t's scattered scalars and P-wide rows
//      (groups outside the active set keep those);
//   4. the step, one thread per group (per mailbox column on the active
//      set) over the row-major [G] and [G, P] tensors as they are:
//      scalars and P-wide rows in registers (P is a template parameter,
//      1..8), the two ring slots it reads (the previous index's, the
//      agreed index's) read at their runtime positions; it writes the
//      fields it changes, the egress, and the one ring slot an accepted
//      batch changes. Groups wider than 8 peers take one instance of
//      runtime width (any P): it recomputes each P-wide row entry from
//      the inputs where it is used and picks the agreed index by rank
//      selection (quorum_net.cuh), P*P reads with no per-thread array.
// No state tensor is written in place: every field the step changes goes
// to a fresh output, the others pass through. The step reads only the
// inputs and the maps, never the outputs it writes, so on the active set
// a pad column that reads row G-1 cannot race the column that owns row
// G-1. (A first version wrote each group's ring row from the step's own
// thread: K dependent, uncoalesced loads per thread bound it by load
// latency at 12-17 us a step on the H100.)
//
// The plain version's arithmetic is reproduced bit for bit:
// - torch's and JAX's '%' floors, C++'s truncates: every ring slot goes
//   through floor_mod (term_at(-1) reads slot K-1);
// - torch and XLA wrap int32 sums and differences; signed overflow in
//   C++ is undefined, so they go through wadd/wsub in uint32;
// - JAX's index modes: a negative id wraps once, an id still out of
//   range drops its scatter (and the active-set gather clamps it);
//   a self_slot in [-P, 0) wraps once for the self vote and one still
//   outside [0, P) reads True; sender_slot outside [0, P) matches no
//   peer column (nor does a negative self_slot in the commit scan).
//
// Bound on an H100 SXM (3.35 TB/s): per group the step reads its state
// (15 int32 scalars, 2 int32 and 4 bool P-wide rows, the K-wide ring)
// and 24 int32 mailbox rows, and writes 10 int32 scalars, 2 int32 and 2
// bool P-wide rows, the ring and 17 int32 egress rows: 586 bytes at P=3,
// K=32, 6.0 MB at G=10240, about 1.8 us. The integer work (a few hundred
// operations a group, most of them the K ring slots) is far below the
// card's rate. chip_smoke.py recounts the bound from its inputs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quorum_net.cuh"

namespace {

// one thread per group or column: 64-thread blocks spread G = 10240 over
// every SM (160 blocks) instead of 40 of the 132; one thread per ring
// slot: 256-thread blocks
constexpr int kThreads = 64;
constexpr int kApplyThreads = 256;

// ops/consensus.py constants
constexpr int32_t MSG_NONE = 0, MSG_AER = 1, MSG_AER_REPLY = 2,
                  MSG_VOTE_REQ = 3, MSG_VOTE_REPLY = 4, MSG_PREVOTE_REQ = 5,
                  MSG_PREVOTE_REPLY = 6;
constexpr int32_t R_FOLLOWER = 0, R_PRE_VOTE = 1, R_CANDIDATE = 2,
                  R_LEADER = 3;
constexpr int32_t AER_STALE = 0, AER_OK = 1, AER_MISMATCH = 2,
                  AER_BEHIND_SNAPSHOT = 3;

// rows of the packed mailbox: MBOX_FIELDS then MBOX_SCAT_FIELDS
// (tests/test_torch_step.py holds these enums, and the pointer order of
// state_in and state_out, against the lists of ops/consensus.py and
// ops/step.py)
enum MboxRow {
  M_MSG_TYPE, M_SENDER_SLOT, M_TERM, M_PREV_IDX, M_PREV_TERM, M_NUM_ENTRIES,
  M_ENTRIES_LAST_TERM, M_LEADER_COMMIT, M_SUCCESS, M_REPLY_NEXT_IDX,
  M_REPLY_LAST_IDX, M_REPLY_LAST_TERM, M_CAND_LAST_IDX, M_CAND_LAST_TERM,
  M_CAND_MACHINE_VERSION, M_HOST_TERM_IDX, M_HOST_TERM_VAL, M_TOKEN,
  M_A_GID, M_A_LO, M_A_HI, M_A_TERM, M_W_GID, M_W_IDX, N_MBOX_ROWS
};

// rows of the packed egress: EGRESS_FIELDS
enum EgressRow {
  E_SEND_REPLY, E_REPLY_TYPE, E_TERM, E_SUCCESS, E_NEXT_INDEX,
  E_LAST_INDEX, E_LAST_TERM, E_AER_CODE, E_BECAME_LEADER,
  E_BECAME_CANDIDATE, E_COMMIT_ADVANCED_TO, E_NEEDS_HOST,
  E_TERM_OR_VOTE_CHANGED, E_ROLE, E_LEADER_SLOT, E_AGREED_IDX,
  E_VOTED_FOR, N_EGRESS_ROWS
};

// GroupState, in field order (ops/step.py STATE_FIELDS)
struct StateIn {
  const int32_t *current_term, *voted_for, *commit_index, *last_applied,
      *last_index, *last_term, *written_index, *snapshot_index,
      *snapshot_term, *role, *leader_slot, *self_slot, *machine_version,
      *match_index, *next_index;
  const uint8_t *voting, *active, *votes, *pre_votes;
  const int32_t *term_suffix, *unknown_lo, *unknown_hi, *pre_vote_token;
};

// the fields the step changes, in ops/step.py OUT_FIELDS order
struct StateOut {
  int32_t *current_term, *voted_for, *commit_index, *last_index, *last_term,
      *written_index, *role, *leader_slot, *match_index, *next_index;
  uint8_t *votes, *pre_votes;
  int32_t *term_suffix, *unknown_lo, *unknown_hi;
};

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}
// a % k with the sign of k (k >= 1), as torch and JAX compute it
__device__ __forceinline__ int floor_mod(int32_t a, int k) {
  const int r = a % k;
  return r < 0 ? r + k : r;
}

// One group after the packed scatters: its scalars, and its ring as the
// input row with the group's appended run (if any) laid over it.
struct Group {
  int32_t current_term, voted_for, commit_index, last_index, last_term,
      written_index, snapshot_index, snapshot_term, role, leader_slot,
      self_slot, machine_version, unknown_lo, unknown_hi, pre_vote_token;
  const int32_t* ring;  // the input ring row
  bool has_run;
  int32_t run_lo, run_hi, run_term;  // run_lo = max(a_lo, a_hi - (K-1))
};

// does the group's appended run cover ring slot s? It does where the
// largest index i <= a_hi with i % K == s lies at or above run_lo
__device__ __forceinline__ bool run_covers(const Group& gr, int s, int k) {
  return gr.has_run &&
         wsub(gr.run_hi, floor_mod(wsub(gr.run_hi, s), k)) >= gr.run_lo;
}

// slot s of the scattered ring
__device__ __forceinline__ int32_t ring_at(const Group& gr, int s, int k) {
  return run_covers(gr, s, k) ? gr.run_term : gr.ring[s];
}

// The group's appended run, if any: the ring's row and the run's bounds.
__device__ __forceinline__ void load_run(Group& gr, const StateIn& in,
                                         const int32_t* packed, size_t S,
                                         int r, int k,
                                         const int32_t* row_of) {
  gr.ring = in.term_suffix + static_cast<size_t>(r) * k;
  const int a = row_of[r] - 1;  // packed column of the group's run, or -1
  gr.has_run = a >= 0;
  gr.run_lo = gr.run_hi = gr.run_term = 0;
  if (gr.has_run) {
    gr.run_hi = packed[M_A_HI * S + a];
    gr.run_term = packed[M_A_TERM * S + a];
    gr.run_lo = max(packed[M_A_LO * S + a], wsub(gr.run_hi, k - 1));
  }
}

__device__ __forceinline__ Group load_group(const StateIn& in,
                                            const int32_t* packed, size_t S,
                                            int r, int k,
                                            const int32_t* row_of,
                                            const uint32_t* wmax) {
  Group gr;
  gr.current_term = in.current_term[r];
  gr.voted_for = in.voted_for[r];
  gr.commit_index = in.commit_index[r];
  gr.snapshot_index = in.snapshot_index[r];
  gr.snapshot_term = in.snapshot_term[r];
  gr.role = in.role[r];
  gr.leader_slot = in.leader_slot[r];
  gr.self_slot = in.self_slot[r];
  gr.machine_version = in.machine_version[r];
  gr.pre_vote_token = in.pre_vote_token[r];
  load_run(gr, in, packed, S, r, k, row_of);
  const int32_t last = in.last_index[r];
  if (gr.has_run) {
    gr.last_index = max(last, gr.run_hi);
    gr.last_term = ring_at(gr, floor_mod(gr.last_index, k), k);
    gr.unknown_lo = 1;
    gr.unknown_hi = 0;
  } else {
    gr.last_index = last;
    gr.last_term = in.last_term[r];
    gr.unknown_lo = in.unknown_lo[r];
    gr.unknown_hi = in.unknown_hi[r];
  }
  // the watermark map holds max(w_idx) biased to unsigned order; 0 (no
  // watermark) decodes to INT32_MIN, which leaves the max unchanged
  gr.written_index =
      max(in.written_index[r], static_cast<int32_t>(wmax[r] ^ 0x80000000u));
  return gr;
}

// term_at: (term, known) of the entry at idx, from the ring window, the
// snapshot boundary or index 0; ring_val is the ring at floor_mod(idx, K)
__device__ __forceinline__ void term_at(int32_t idx, int32_t last_index,
                                        int32_t snapshot_index,
                                        int32_t snapshot_term, int32_t ulo,
                                        int32_t uhi, int32_t ring_val, int k,
                                        int32_t* term, bool* known) {
  const bool in_window =
      idx > max(wsub(last_index, k), snapshot_index) && idx <= last_index;
  const bool is_snap = idx == snapshot_index;
  const bool is_zero = idx <= 0;
  const bool stale = idx >= ulo && idx <= uhi;
  *term = is_zero ? 0 : (is_snap ? snapshot_term : ring_val);
  *known = is_zero || is_snap || (in_window && !stale);
}

// One thread per scatter row j: the maps row_of (j + 1 of each group's
// appended run) and wmax (max watermark, biased), zeroed beforehand.
__global__ void __launch_bounds__(kThreads)
    scatter_index_kernel(const int32_t* __restrict__ packed, int s_width,
                         int g, int32_t* __restrict__ row_of,
                         uint32_t* __restrict__ wmax) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= s_width) return;
  const size_t S = s_width;
  int64_t a = packed[M_A_GID * S + j];
  if (a < 0) a += g;  // a negative id wraps once; out of range drops
  if (a >= 0 && a < g) atomicMax(&row_of[a], j + 1);
  int64_t w = packed[M_W_GID * S + j];
  if (w < 0) w += g;
  if (w >= 0 && w < g) {
    atomicMax(&wmax[w], static_cast<uint32_t>(packed[M_W_IDX * S + j]) ^ 0x80000000u);
  }
}

// One thread per ring slot (G*K threads, coalesced): every group's
// scattered ring into the outputs. On the active set, thread t < G also
// writes group t's scattered scalars and P-wide rows (at full width the
// step writes those for every group). The step then overwrites what it
// changes.
__global__ void __launch_bounds__(kApplyThreads)
    apply_scatters_kernel(const StateIn in, const StateOut out,
                          const int32_t* __restrict__ packed, int s_width,
                          const int32_t* __restrict__ row_of,
                          const uint32_t* __restrict__ wmax, int g, int p,
                          int k, bool all_fields) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(g) * k) return;
  Group gr;
  const int row = static_cast<int>(t / k);
  load_run(gr, in, packed, s_width, row, k, row_of);
  out.term_suffix[t] = ring_at(gr, static_cast<int>(t - static_cast<int64_t>(row) * k), k);
  if (!all_fields || t >= g) return;
  const int r = static_cast<int>(t);
  gr = load_group(in, packed, s_width, r, k, row_of, wmax);
  out.current_term[r] = gr.current_term;
  out.voted_for[r] = gr.voted_for;
  out.commit_index[r] = gr.commit_index;
  out.last_index[r] = gr.last_index;
  out.last_term[r] = gr.last_term;
  out.written_index[r] = gr.written_index;
  out.role[r] = gr.role;
  out.leader_slot[r] = gr.leader_slot;
  out.unknown_lo[r] = gr.unknown_lo;
  out.unknown_hi[r] = gr.unknown_hi;
  const size_t rp = static_cast<size_t>(r) * p;
  for (int s = 0; s < p; ++s) {
    out.match_index[rp + s] = in.match_index[rp + s];
    out.next_index[rp + s] = in.next_index[rp + s];
    out.votes[rp + s] = in.votes[rp + s];
    out.pre_votes[rp + s] = in.pre_votes[rp + s];
  }
}

// The step: thread j takes mailbox column j. Full width (gidx null):
// column j is group j. Active set: column j reads the scattered state of
// group clamp(wrap(gidx[j])) and writes group wrap(gidx[j]) if in range.
// P = 1..8 is the peer width, fixed at compile time; P = 0 takes
// the runtime width p (any p >= 1).
template <int P>
__global__ void __launch_bounds__(kThreads)
    step_kernel(const StateIn in, const StateOut out,
                const int32_t* __restrict__ packed,
                const int32_t* __restrict__ gidx, int s_width,
                const int32_t* __restrict__ row_of,
                const uint32_t* __restrict__ wmax, int g, int p, int k,
                int32_t* __restrict__ egress) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= s_width) return;
  int src = j, dst = j;
  if (gidx != nullptr) {
    int64_t x = gidx[j];
    if (x < 0) x += g;
    dst = (x >= 0 && x < g) ? static_cast<int>(x) : -1;
    src = static_cast<int>(x < 0 ? 0 : (x >= g ? g - 1 : x));
  }
  const size_t S = s_width;
  const int32_t* col = packed + j;
  const int32_t msg_type = col[M_MSG_TYPE * S];
  const int32_t sender = col[M_SENDER_SLOT * S];
  const int32_t mterm = col[M_TERM * S];
  const int32_t prev_idx = col[M_PREV_IDX * S];
  const int32_t prev_term = col[M_PREV_TERM * S];
  const int32_t num_entries = col[M_NUM_ENTRIES * S];
  const int32_t entries_last_term = col[M_ENTRIES_LAST_TERM * S];
  const int32_t leader_commit = col[M_LEADER_COMMIT * S];
  const bool success = col[M_SUCCESS * S] != 0;
  const int32_t reply_next_idx = col[M_REPLY_NEXT_IDX * S];
  const int32_t reply_last_idx = col[M_REPLY_LAST_IDX * S];
  const int32_t cand_last_idx = col[M_CAND_LAST_IDX * S];
  const int32_t cand_last_term = col[M_CAND_LAST_TERM * S];
  const int32_t cand_machine_version = col[M_CAND_MACHINE_VERSION * S];
  const int32_t host_term_idx = col[M_HOST_TERM_IDX * S];
  const int32_t host_term_val = col[M_HOST_TERM_VAL * S];
  const int32_t token = col[M_TOKEN * S];

  const Group gr = load_group(in, packed, S, src, k, row_of, wmax);

  const bool is_aer = msg_type == MSG_AER;
  const bool is_aer_reply = msg_type == MSG_AER_REPLY;
  const bool is_vote_req = msg_type == MSG_VOTE_REQ;
  const bool is_vote_reply = msg_type == MSG_VOTE_REPLY;
  const bool is_prevote_req = msg_type == MSG_PREVOTE_REQ;
  const bool is_prevote_reply = msg_type == MSG_PREVOTE_REPLY;
  const bool has_msg = msg_type != MSG_NONE;

  const int32_t term0 = gr.current_term;
  const int32_t voted0 = gr.voted_for;

  // universal higher-term handling (pre-vote requests excluded)
  const bool bumps_term = has_msg && !is_prevote_req && mterm > term0;
  const int32_t term1 = bumps_term ? mterm : term0;
  const int32_t voted1 = bumps_term ? -1 : voted0;
  const int32_t role1 = bumps_term ? R_FOLLOWER : gr.role;
  const int32_t leader1 = bumps_term ? -1 : gr.leader_slot;

  // ---- AER (follower accept path)
  int32_t local_prev_term;
  bool prev_known;
  term_at(prev_idx, gr.last_index, gr.snapshot_index, gr.snapshot_term,
          gr.unknown_lo, gr.unknown_hi, ring_at(gr, floor_mod(prev_idx, k), k),
          k, &local_prev_term, &prev_known);
  const bool prev_override = host_term_idx == prev_idx && host_term_val >= 0;
  if (prev_override) local_prev_term = host_term_val;
  prev_known = prev_known || prev_override;
  const bool aer_stale = mterm < term1;
  const bool aer_behind = prev_idx < gr.snapshot_index;
  const bool aer_match = prev_known && local_prev_term == prev_term;
  const int32_t aer_code =
      aer_stale ? AER_STALE
                : (aer_behind ? AER_BEHIND_SNAPSHOT
                              : (aer_match ? AER_OK : AER_MISMATCH));
  const bool aer_ok = is_aer && aer_code == AER_OK;
  const int32_t aer_fail_next =
      aer_behind ? wadd(gr.snapshot_index, 1)
                 : (gr.last_index < prev_idx ? wadd(gr.last_index, 1)
                                             : wadd(gr.commit_index, 1));
  const bool aer_needs_host = is_aer && !aer_stale && !aer_behind && !prev_known;

  const int32_t role2 = aer_ok ? R_FOLLOWER : role1;
  const int32_t leader2 = aer_ok ? sender : leader1;

  const int32_t new_last = wadd(prev_idx, num_entries);
  const bool takes_entries = aer_ok && num_entries > 0;
  const int32_t last_index2 = takes_entries ? new_last : gr.last_index;
  const int32_t last_term2 = takes_entries ? entries_last_term : gr.last_term;
  const int tail_slot = floor_mod(new_last, k);
  const bool multi = takes_entries && num_entries > 1;
  const bool had_inv = gr.unknown_lo <= gr.unknown_hi;
  const int32_t prev1 = wadd(prev_idx, 1);
  const int32_t unknown_lo2 =
      multi ? (had_inv ? min(gr.unknown_lo, prev1) : prev1) : gr.unknown_lo;
  const int32_t unknown_hi2 =
      multi ? max(gr.unknown_hi, wsub(new_last, 1)) : gr.unknown_hi;
  const int32_t commit2 =
      aer_ok ? max(gr.commit_index, min(leader_commit, new_last))
             : gr.commit_index;

  // ---- votes
  const bool fresh_term = mterm > term0;
  const bool free_to_vote = fresh_term || voted1 == -1 || voted1 == sender;
  const bool up_to_date =
      cand_last_term > last_term2 ||
      (cand_last_term == last_term2 && cand_last_idx >= last_index2);
  const bool vote_grant =
      is_vote_req && mterm >= term1 && free_to_vote && up_to_date;
  const int32_t voted2 = vote_grant ? sender : voted1;
  const int32_t leader3 = vote_grant ? -1 : leader2;
  const bool prevote_grant = is_prevote_req && mterm >= term1 &&
                             cand_machine_version >= gr.machine_version &&
                             up_to_date;

  // ---- vote replies (candidate / pre-vote path)
  const bool count_vote = is_vote_reply && role1 == R_CANDIDATE && success &&
                          mterm == term1;
  const bool count_prevote = is_prevote_reply && role1 == R_PRE_VOTE &&
                             success && mterm <= term1 &&
                             token == gr.pre_vote_token;
  // P-wide rows. P >= 1: the rows live in registers and the loops over
  // them unroll. P == 0 (groups wider than the register instances): the
  // width is the runtime p, and each row entry is recomputed from the
  // inputs where it is used, so no per-thread array bounds the width.
  const int np = P > 0 ? P : p;
  const size_t rp = static_cast<size_t>(src) * np;
  auto member_at = [&](int s) {
    return in.voting[rp + s] != 0 && in.active[rp + s] != 0;
  };
  auto vote_at = [&](int s) {
    return ((count_vote && s == sender) || in.votes[rp + s] != 0) &&
           role1 == R_CANDIDATE;
  };
  auto pre_vote_at = [&](int s) {
    return ((count_prevote && s == sender) || in.pre_votes[rp + s] != 0) &&
           role1 == R_PRE_VOTE;
  };
  constexpr int A = P > 0 ? P : 1;  // register rows (unused when P == 0)
  bool members[A], votes2[A], pre_votes2[A];
  int n_voters = 0, n_votes = 0, n_prevotes = 0;
  // take_along_axis: a self slot in [-P, 0) wraps once, one still out
  // of range reads True (fill mode)
  bool self_vote = true;
  const int32_t self_at =
      gr.self_slot < 0 ? gr.self_slot + (P > 0 ? P : p) : gr.self_slot;
  if constexpr (P > 0) {
#pragma unroll
    for (int s = 0; s < P; ++s) {
      members[s] = member_at(s);
      votes2[s] = vote_at(s);
      pre_votes2[s] = pre_vote_at(s);
      n_voters += members[s];
      n_votes += votes2[s] && members[s];
      n_prevotes += pre_votes2[s] && members[s];
    }
    // an in-range self slot is read from a per-thread array at its
    // runtime position (quorum_net.cuh says why not a register select)
    if (self_at >= 0 && self_at < P) {
      bool member_of[P];
#pragma unroll
      for (int s = 0; s < P; ++s) member_of[s] = members[s];
      self_vote = member_of[self_at];
    }
  } else {
    for (int s = 0; s < p; ++s) {
      const bool m = member_at(s);
      n_voters += m;
      n_votes += vote_at(s) && m;
      n_prevotes += pre_vote_at(s) && m;
    }
    if (self_at >= 0 && self_at < p) {
      self_vote = member_at(self_at);
    }
  }
  const int quorum_n = n_voters / 2 + 1;
  n_votes += self_vote && role1 == R_CANDIDATE;
  n_prevotes += self_vote && role1 == R_PRE_VOTE;
  const bool became_leader = role1 == R_CANDIDATE && n_votes >= quorum_n;
  const bool became_candidate = role1 == R_PRE_VOTE && n_prevotes >= quorum_n;

  int32_t role3 = became_leader ? R_LEADER : role2;
  role3 = became_candidate ? R_CANDIDATE : role3;
  // candidate promotion bumps the term and votes for self
  const int32_t term2 = became_candidate ? wadd(term1, 1) : term1;
  const int32_t voted3 = became_candidate ? gr.self_slot : voted2;
  const int32_t leader4 = became_leader ? gr.self_slot : leader3;

  // ---- new leader resets peer bookkeeping; AER replies (leader path)
  const bool lead_ok = is_aer_reply && role3 == R_LEADER && mterm == term2;
  const int32_t reply_last1 = wadd(reply_last_idx, 1);
  const int32_t hint_base = min(reply_next_idx, reply_last1);
  // slot s of the leader's match and next rows after this step
  auto peer_at = [&](int s, int32_t& match3, int32_t& next4) {
    const int32_t match2 = became_leader ? 0 : in.match_index[rp + s];
    const int32_t next2 =
        became_leader ? wadd(last_index2, 1) : in.next_index[rp + s];
    const bool onehot = s == sender;
    const bool succ = lead_ok && success && onehot;
    match3 = succ ? max(match2, reply_last_idx) : match2;
    const int32_t next3 = succ ? max(next2, reply_last1) : next2;
    const bool fail = lead_ok && !success && onehot;
    const int32_t fail_hint = max(hint_base, wadd(match3, 1));
    next4 = fail ? max(fail_hint, 1) : next3;
  };
  int32_t match3[A], next4[A];
  if constexpr (P > 0) {
#pragma unroll
    for (int s = 0; s < P; ++s) peer_at(s, match3[s], next4[s]);
  }

  // ---- quorum commit scan (leaders, every step): the network on
  // registers, or for P == 0 the rank selection over recomputed entries
  auto eff_at = [&](int s, bool member, int32_t match) {
    return member ? (s == gr.self_slot ? gr.written_index : match) : -1;
  };
  int32_t agreed;
  if constexpr (P > 0) {
    int32_t eff[P];
#pragma unroll
    for (int s = 0; s < P; ++s) eff[s] = eff_at(s, members[s], match3[s]);
    agreed = quorum_pick<P>(eff, n_voters);
  } else {
    agreed = quorum_pick_rank(
        [&](int s) {
          int32_t m3, n4;
          peer_at(s, m3, n4);
          return eff_at(s, member_at(s), m3);
        },
        np, n_voters);
  }
  const int agreed_slot = floor_mod(agreed, k);
  const int32_t agreed_ring = (takes_entries && agreed_slot == tail_slot)
                                  ? entries_last_term
                                  : ring_at(gr, agreed_slot, k);
  int32_t agreed_term;
  bool agreed_known;
  term_at(agreed, last_index2, gr.snapshot_index, gr.snapshot_term,
          unknown_lo2, unknown_hi2, agreed_ring, k, &agreed_term,
          &agreed_known);
  const bool agreed_override = host_term_idx == agreed && host_term_val >= 0;
  if (agreed_override) agreed_term = host_term_val;
  agreed_known = agreed_known || agreed_override;
  const bool can_commit = role3 == R_LEADER && agreed > commit2 &&
                          agreed_known && agreed_term == term2;
  const int32_t commit3 = can_commit ? agreed : commit2;
  const bool quorum_needs_host =
      role3 == R_LEADER && agreed > commit2 && !agreed_known;

  // ---- egress
  const bool reply_success =
      is_aer ? aer_code == AER_OK
             : (is_vote_req ? vote_grant : (is_prevote_req && prevote_grant));
  // AER success replies report the durable watermark
  const int32_t wi = aer_ok ? gr.written_index : last_index2;
  const int32_t reply_next =
      (is_aer && aer_code != AER_OK) ? aer_fail_next : wadd(wi, 1);
  int32_t* e = egress + j;
  e[E_SEND_REPLY * S] =
      has_msg && ((is_aer && !aer_needs_host) || is_vote_req || is_prevote_req);
  e[E_REPLY_TYPE * S] = msg_type;
  e[E_TERM * S] = term2;
  e[E_SUCCESS * S] = reply_success;
  e[E_NEXT_INDEX * S] = reply_next;
  e[E_LAST_INDEX * S] = (is_aer && aer_ok) ? wi : last_index2;
  e[E_LAST_TERM * S] = last_term2;
  e[E_AER_CODE * S] = is_aer ? aer_code : -1;
  e[E_BECAME_LEADER * S] = became_leader;
  e[E_BECAME_CANDIDATE * S] = became_candidate;
  e[E_COMMIT_ADVANCED_TO * S] = commit3;
  e[E_NEEDS_HOST * S] = aer_needs_host || quorum_needs_host;
  e[E_TERM_OR_VOTE_CHANGED * S] = term2 != term0 || voted3 != voted0;
  e[E_ROLE * S] = role3;
  e[E_LEADER_SLOT * S] = leader4;
  e[E_AGREED_IDX * S] = agreed;
  e[E_VOTED_FOR * S] = voted3;

  if (dst < 0) return;  // a pad column: its writes drop
  out.current_term[dst] = term2;
  out.voted_for[dst] = voted3;
  out.commit_index[dst] = commit3;
  out.last_index[dst] = last_index2;
  out.last_term[dst] = last_term2;
  out.written_index[dst] = gr.written_index;
  out.role[dst] = role3;
  out.leader_slot[dst] = leader4;
  out.unknown_lo[dst] = unknown_lo2;
  out.unknown_hi[dst] = unknown_hi2;
  const size_t dp = static_cast<size_t>(dst) * np;
  if constexpr (P > 0) {
#pragma unroll
    for (int s = 0; s < P; ++s) {
      out.match_index[dp + s] = match3[s];
      out.next_index[dp + s] = next4[s];
      out.votes[dp + s] = votes2[s] && !became_candidate;
      out.pre_votes[dp + s] = pre_votes2[s] && !became_candidate;
    }
  } else {
    for (int s = 0; s < p; ++s) {
      int32_t m3, n4;
      peer_at(s, m3, n4);
      out.match_index[dp + s] = m3;
      out.next_index[dp + s] = n4;
      out.votes[dp + s] = vote_at(s) && !became_candidate;
      out.pre_votes[dp + s] = pre_vote_at(s) && !became_candidate;
    }
  }
  // the scattered ring is already in place (apply_scatters_kernel): an
  // accepted batch changes only its tail slot
  if (takes_entries) {
    out.term_suffix[static_cast<size_t>(dst) * k + tail_slot] =
        entries_last_term;
  }
}

StateIn state_in(const void* const* p) {
  StateIn s;
  const int32_t* const* i = reinterpret_cast<const int32_t* const*>(p);
  const uint8_t* const* b = reinterpret_cast<const uint8_t* const*>(p);
  s.current_term = i[0];
  s.voted_for = i[1];
  s.commit_index = i[2];
  s.last_applied = i[3];
  s.last_index = i[4];
  s.last_term = i[5];
  s.written_index = i[6];
  s.snapshot_index = i[7];
  s.snapshot_term = i[8];
  s.role = i[9];
  s.leader_slot = i[10];
  s.self_slot = i[11];
  s.machine_version = i[12];
  s.match_index = i[13];
  s.next_index = i[14];
  s.voting = b[15];
  s.active = b[16];
  s.votes = b[17];
  s.pre_votes = b[18];
  s.term_suffix = i[19];
  s.unknown_lo = i[20];
  s.unknown_hi = i[21];
  s.pre_vote_token = i[22];
  return s;
}

StateOut state_out(void* const* p) {
  StateOut s;
  int32_t* const* i = reinterpret_cast<int32_t* const*>(p);
  uint8_t* const* b = reinterpret_cast<uint8_t* const*>(p);
  s.current_term = i[0];
  s.voted_for = i[1];
  s.commit_index = i[2];
  s.last_index = i[3];
  s.last_term = i[4];
  s.written_index = i[5];
  s.role = i[6];
  s.leader_slot = i[7];
  s.match_index = i[8];
  s.next_index = i[9];
  s.votes = b[10];
  s.pre_votes = b[11];
  s.term_suffix = i[12];
  s.unknown_lo = i[13];
  s.unknown_hi = i[14];
  return s;
}

// ---- host launchers (nvcc only): everything above is plain C++ apart
// from the CUDA keywords, and tests/test_torch_step_host.py compiles it
// with a host compiler behind a small shim to run the kernels' code on
// the CPU.

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

template <int P>
void launch_step(const StateIn& in, const StateOut& out, const int32_t* packed,
                 const int32_t* gidx, int s_width, const int32_t* row_of,
                 const uint32_t* wmax, int g, int p, int k, int32_t* egress,
                 cudaStream_t stream) {
  step_kernel<P><<<blocks_for(s_width), kThreads, 0, stream>>>(
      in, out, packed, gidx, s_width, row_of, wmax, g, p, k, egress);
}

// the memset, the pre-pass, the scattered copy and the step, on stream
int launch_all(const void* const* in_ptrs, void* const* out_ptrs,
               const void* packed_v, const void* gidx_v, void* egress_v,
               void* maps_v, int g, int p, int k, int s_width,
               cudaStream_t stream) {
  if (g <= 0 || k <= 0 || s_width <= 0 || p < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const StateIn in = state_in(in_ptrs);
  const StateOut out = state_out(out_ptrs);
  const int32_t* packed = static_cast<const int32_t*>(packed_v);
  const int32_t* gidx = static_cast<const int32_t*>(gidx_v);
  int32_t* egress = static_cast<int32_t*>(egress_v);
  int32_t* row_of = static_cast<int32_t*>(maps_v);
  uint32_t* wmax = reinterpret_cast<uint32_t*>(row_of + g);
  cudaError_t err = cudaMemsetAsync(maps_v, 0, sizeof(int32_t) * 2 * static_cast<size_t>(g), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_index_kernel<<<blocks_for(s_width), kThreads, 0, stream>>>(
      packed, s_width, g, row_of, wmax);
  const int64_t slots = static_cast<int64_t>(g) * k;
  apply_scatters_kernel<<<static_cast<int>((slots + kApplyThreads - 1) /
                                           kApplyThreads),
                          kApplyThreads, 0, stream>>>(
      in, out, packed, s_width, row_of, wmax, g, p, k, gidx != nullptr);
  switch (p) {
    case 1: launch_step<1>(in, out, packed, gidx, s_width, row_of, wmax, g, p, k, egress, stream); break;
    case 2: launch_step<2>(in, out, packed, gidx, s_width, row_of, wmax, g, p, k, egress, stream); break;
    case 3: launch_step<3>(in, out, packed, gidx, s_width, row_of, wmax, g, p, k, egress, stream); break;
    case 4: launch_step<4>(in, out, packed, gidx, s_width, row_of, wmax, g, p, k, egress, stream); break;
    case 5: launch_step<5>(in, out, packed, gidx, s_width, row_of, wmax, g, p, k, egress, stream); break;
    case 6: launch_step<6>(in, out, packed, gidx, s_width, row_of, wmax, g, p, k, egress, stream); break;
    case 7: launch_step<7>(in, out, packed, gidx, s_width, row_of, wmax, g, p, k, egress, stream); break;
    case 8: launch_step<8>(in, out, packed, gidx, s_width, row_of, wmax, g, p, k, egress, stream); break;
    default: launch_step<0>(in, out, packed, gidx, s_width, row_of, wmax, g, p, k, egress, stream); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entry points launch on `stream`, synchronise nothing and allocate
// nothing. in: the 23 GroupState field pointers in field order; out: the
// 15 changed-field outputs; maps: 2*g int32 of scratch; egress: (17, S)
// int32. Return cudaGetLastError() after the launches (0 on success).

// full width: packed is (24, g), S = g
extern "C" int ra_step_full_launch(const void* const* in, void* const* out,
                                   const void* packed, void* egress,
                                   void* maps, int g, int p, int k,
                                   void* stream) {
  return launch_all(in, out, packed, nullptr, egress, maps, g, p, k, g,
                    static_cast<cudaStream_t>(stream));
}

// active set: packed is (24, s), gidx is (s,)
extern "C" int ra_step_sub_launch(const void* const* in, void* const* out,
                                  const void* packed, const void* gidx,
                                  void* egress, void* maps, int g, int p,
                                  int k, int s, void* stream) {
  if (gidx == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_all(in, out, packed, gidx, egress, maps, g, p, k, s,
                    static_cast<cudaStream_t>(stream));
}
