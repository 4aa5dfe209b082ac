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
// Design: one cooperative launch a step, on both paths (step_kernel).
//   Phase A, the scatter index: a grid-stride pass over the S columns
//     fills three [G] maps of a persistent scratch: the packed column of
//     each group's appended run (atomicMax, so the last listed column
//     wins if a caller breaks the contract that a_gid ids are unique, as
//     JAX requires), the max of its watermarks (atomicMax: duplicate
//     w_gid ids reduce by max) and, on the active set, the owner tag of
//     every group a real column writes. Each entry carries the launch's
//     epoch (the wrapper passes a fresh one each launch) and is read
//     only when its epoch is this launch's, so the scratch is never
//     cleared between steps: no memset.
//   One grid barrier.
//   Phase B, tiles of kThreads rows, blocks looping over them: the tiles
//     of step columns, then (active set only) the chunks of groups that
//     pass through. For each tile:
//     1. stage and prologue: the tile's ring rows go into shared memory,
//        one 1-D bulk copy of the contiguous rows (full width,
//        pass-through) or one per gathered row (active set), completing
//        on the block's mbarrier (where an address or a size is not
//        16-byte aligned the block loads the rows with plain coalesced
//        loads instead); each thread reads what needs no map: its mailbox
//        column, its group's scalars and (P <= 8) its P-wide rows into
//        registers. A block does both for its first tile before the grid
//        barrier, beside phase A;
//     2. compute: a thread reads its group's map entries (and its run's
//        bounds), waits on the barrier, lays the run over its row of the
//        tile and runs the step, reading the two ring slots it needs (the
//        previous index's, the agreed index's) from shared memory and
//        writing the tail slot an accepted batch changes there; a pass-
//        through thread writes its group's scattered scalars and P-wide
//        rows;
//     3. write back: the tile's rows go to the output ring in coalesced
//        16-byte stores.
//     On the active set a group that a real column writes is written by
//     that column only, every other group by its pass-through chunk;
//     pad columns read the clamped row and drop their writes.
//   P = 1..8 are template parameters (the P-wide rows in registers);
//   wider groups take one instance of runtime width (any P): it
//   recomputes each P-wide row entry from the inputs where it is used
//   and picks the agreed index by rank selection (quorum_net.cuh), P*P
//   reads with no per-thread array.
// No state tensor is written in place: every field the step changes goes
// to a fresh output, the others pass through. The step reads only the
// inputs, the maps and its own tile, never the outputs it writes. The
// ring goes through shared memory because a thread reading its K ring
// slots from device memory, uncoalesced, is bound by load latency
// (12-17 us a step on the H100).
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
// operations a group) is far below the card's rate. chip_smoke.py
// recounts the bound from its inputs. What holds the kernel above it is
// latency: one thread a group is 10240 threads, about one warp per
// scheduler of the 132 SMs, each thread a chain of dependent loads (the
// maps, then its run's bounds) and a few hundred dependent instructions,
// behind a grid barrier. The design moves every load that needs no map
// ahead of the barrier and keeps per-slot division out of the loops.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quorum_net.cuh"
#include "step_async.cuh"

namespace {

// rows a tile and threads a block: G = 10240 makes 80 tiles (the active
// set's 2048 columns 16, beside 80 pass-through chunks), few blocks to
// wait at the grid barrier; the ring tile is 128*K int32 (16 KB at
// K=32), so shared memory takes K up to about 450
constexpr int kThreads = 128;

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

// Everything a launch reads and writes. The scratch holds three [G]
// maps, each entry tagged with the epoch of the launch that wrote it:
// run_map (epoch, packed column + 1 of the group's appended run),
// wmax_map (epoch, max watermark biased to unsigned order) and owner
// (the epoch, where a real active-set column writes the group).
struct Args {
  StateIn in;
  StateOut out;
  const int32_t* packed;  // (24, s)
  const int32_t* gidx;    // (s,) on the active set, else null
  int32_t* egress;        // (17, s)
  unsigned long long* run_map;
  unsigned long long* wmax_map;
  uint32_t* owner;
  uint32_t epoch;
  int g, p, k, s;
  int col_tiles;  // tiles of step columns
  int items;      // col_tiles, then the pass-through chunks (active set)
};

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}
// a % k with the sign of k (k >= 1), as torch and JAX compute it; for a
// power of two (K = 32 on the main path) the low bits of a's two's
// complement
__device__ __forceinline__ int floor_mod(int32_t a, int k) {
  if ((k & (k - 1)) == 0) {
    return static_cast<int>(static_cast<uint32_t>(a) & static_cast<uint32_t>(k - 1));
  }
  const int r = a % k;
  return r < 0 ? r + k : r;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ unsigned long long tagged(uint32_t epoch,
                                                     uint32_t v) {
  return (static_cast<unsigned long long>(epoch) << 32) | v;
}

// ---- phase A: the scatter index, this thread's columns (grid-stride)

__device__ __forceinline__ void scatter_index(const Args& a) {
  const size_t S = a.s;
  const int nthreads = gridDim.x * blockDim.x;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < a.s; j += nthreads) {
    int64_t x = a.packed[M_A_GID * S + j];
    if (x < 0) x += a.g;  // a negative id wraps once; out of range drops
    if (x >= 0 && x < a.g) {
      atomicMax(&a.run_map[x], tagged(a.epoch, static_cast<uint32_t>(j) + 1));
    }
    x = a.packed[M_W_GID * S + j];
    if (x < 0) x += a.g;
    if (x >= 0 && x < a.g) {
      const uint32_t w = static_cast<uint32_t>(a.packed[M_W_IDX * S + j]);
      atomicMax(&a.wmax_map[x], tagged(a.epoch, w ^ 0x80000000u));
    }
    if (a.gidx != nullptr) {
      x = a.gidx[j];
      if (x < 0) x += a.g;
      if (x >= 0 && x < a.g) a.owner[x] = a.epoch;
    }
  }
}

// the packed column of group r's appended run in this launch, or -1
__device__ __forceinline__ int run_column(const Args& a, int r) {
  const unsigned long long e = load_cg(&a.run_map[r]);
  return (e >> 32) == a.epoch
             ? static_cast<int>(static_cast<uint32_t>(e)) - 1
             : -1;
}

// does a real active-set column write group r in this launch?
__device__ __forceinline__ bool owned(const Args& a, int r) {
  return load_cg(&a.owner[r]) == a.epoch;
}

// ---- the group a thread steps or passes through

// One group after the packed scatters: its scalars, and its ring as its
// row of the tile with the group's appended run (if any) laid over it.
struct Group {
  int32_t current_term, voted_for, commit_index, last_index, last_term,
      written_index, snapshot_index, snapshot_term, role, leader_slot,
      self_slot, machine_version, unknown_lo, unknown_hi, pre_vote_token;
  int32_t* ring;  // the group's row of the tile (shared memory)
  bool has_run;
  int32_t run_lo, run_hi, run_term;  // run_lo = max(a_lo, a_hi - (K-1))
};

// does the group's appended run cover ring slot s? It does where the
// largest index i <= a_hi with i % K == s lies at or above run_lo
__device__ __forceinline__ bool run_covers(const Group& gr, int s, int k) {
  return gr.has_run &&
         wsub(gr.run_hi, floor_mod(wsub(gr.run_hi, s), k)) >= gr.run_lo;
}

// group r's input scalars (before the grid barrier: nothing here reads
// the maps)
__device__ __forceinline__ Group load_scalars(const Args& a, int r) {
  const StateIn& in = a.in;
  Group gr;
  gr.current_term = in.current_term[r];
  gr.voted_for = in.voted_for[r];
  gr.commit_index = in.commit_index[r];
  gr.last_index = in.last_index[r];
  gr.last_term = in.last_term[r];
  gr.written_index = in.written_index[r];
  gr.snapshot_index = in.snapshot_index[r];
  gr.snapshot_term = in.snapshot_term[r];
  gr.role = in.role[r];
  gr.leader_slot = in.leader_slot[r];
  gr.self_slot = in.self_slot[r];
  gr.machine_version = in.machine_version[r];
  gr.unknown_lo = in.unknown_lo[r];
  gr.unknown_hi = in.unknown_hi[r];
  gr.pre_vote_token = in.pre_vote_token[r];
  gr.ring = nullptr;
  gr.has_run = false;
  gr.run_lo = gr.run_hi = gr.run_term = 0;
  return gr;
}

// group r after the packed scatters of this launch (the maps): its
// watermark, its run's bounds and the tail fields the run moves (the
// ring row is not read here: see lay_run)
__device__ __forceinline__ void apply_maps(const Args& a, Group& gr, int r) {
  const int c = run_column(a, r);
  const unsigned long long w = load_cg(&a.wmax_map[r]);
  if ((w >> 32) == a.epoch) {
    gr.written_index = max(
        gr.written_index,
        static_cast<int32_t>(static_cast<uint32_t>(w) ^ 0x80000000u));
  }
  gr.has_run = c >= 0;
  if (!gr.has_run) return;
  const size_t S = a.s;
  gr.run_hi = a.packed[M_A_HI * S + c];
  gr.run_term = a.packed[M_A_TERM * S + c];
  gr.run_lo = max(a.packed[M_A_LO * S + c], wsub(gr.run_hi, a.k - 1));
  gr.last_index = max(gr.last_index, gr.run_hi);
  gr.last_term = 0;  // read from the ring in lay_run
  gr.unknown_lo = 1;
  gr.unknown_hi = 0;
}

// Lay the group's appended run over its row of the staged tile (the
// tile must have arrived), and read last_term from the scattered ring.
// Where run_hi - (K-1) does not wrap, slot s holds index run_hi - d with
// d = (run_hi - s) mod K, and the run covers the d <= run_hi - run_lo:
// the run's own slots, walked down from run_hi's, cost one modulo.
// Otherwise every slot takes run_covers, as the plain version computes.
__device__ __forceinline__ void lay_run(Group& gr, int32_t* row, int k) {
  gr.ring = row;
  if (!gr.has_run) return;
  if (gr.run_hi >= INT32_MIN + (k - 1)) {
    const int64_t span = static_cast<int64_t>(gr.run_hi) - gr.run_lo + 1;
    const int n = span <= 0 ? 0 : (span < k ? static_cast<int>(span) : k);
    int s = floor_mod(gr.run_hi, k);
    for (int d = 0; d < n; ++d) {
      row[s] = gr.run_term;
      s = s == 0 ? k - 1 : s - 1;
    }
  } else {
    for (int s = 0; s < k; ++s) {
      if (run_covers(gr, s, k)) row[s] = gr.run_term;
    }
  }
  gr.last_term = row[floor_mod(gr.last_index, k)];
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

// ---- phase B: the tiles

// One work item of phase B: kThreads rows from `first`. A step tile's
// rows are mailbox columns (gathered through gidx on the active set); a
// pass-through chunk's rows are groups.
struct Tile {
  int first, n;
  bool step, gathered;
};

__device__ __forceinline__ Tile tile_of(const Args& a, int item) {
  Tile t;
  t.step = item < a.col_tiles;
  t.gathered = t.step && a.gidx != nullptr;
  t.first = (t.step ? item : item - a.col_tiles) * kThreads;
  t.n = min(kThreads, (t.step ? a.s : a.g) - t.first);
  return t;
}

// Column j's rows. Full width: group j. Active set: it reads the
// scattered state of group clamp(wrap(gidx[j])) and writes group
// wrap(gidx[j]) if that is in range (dst -1: a pad column).
__device__ __forceinline__ void column_rows(const Args& a, int j, int& src,
                                            int& dst) {
  src = dst = j;
  if (a.gidx != nullptr) {
    int64_t x = a.gidx[j];
    if (x < 0) x += a.g;
    dst = (x >= 0 && x < a.g) ? static_cast<int>(x) : -1;
    src = static_cast<int>(x < 0 ? 0 : (x >= a.g ? a.g - 1 : x));
  }
}

// Sub-phase 1: stage the tile's ring rows (the input ring) into shared
// memory. Every thread arrives on the block's barrier once: with a bulk
// copy's bytes, or after its plain loads.
__device__ __forceinline__ void stage_tile(const Args& a, const Tile& t,
                                           int32_t* tile, uint64_t* bar) {
  const int tid = threadIdx.x, k = a.k;
  const int32_t* ring = a.in.term_suffix;
  if (t.gathered) {  // one row per column, by its own thread
    if (tid < t.n) {
      int src, dst;
      column_rows(a, t.first + tid, src, dst);
      const int32_t* row = ring + static_cast<size_t>(src) * k;
      int32_t* to = tile + tid * k;
      if (aligned16(ring) && k % 4 == 0) {
        bulk_copy(to, row, static_cast<unsigned>(k) * 4, bar);
        return;
      }
      for (int s = 0; s < k; ++s) to[s] = row[s];
    }
    bar_arrive(bar);
    return;
  }
  const int32_t* rows = ring + static_cast<size_t>(t.first) * k;
  const int n = t.n * k;
  if (aligned16(rows) && n % 4 == 0) {  // contiguous: one bulk copy
    if (tid == 0) {
      bulk_copy(tile, rows, static_cast<unsigned>(n) * 4, bar);
      return;
    }
  } else {
    for (int i = tid; i < n; i += blockDim.x) tile[i] = rows[i];
  }
  bar_arrive(bar);
}

// A step column's mailbox rows.
struct Mail {
  int32_t msg_type, sender, mterm, prev_idx, prev_term, num_entries,
      entries_last_term, leader_commit, success, reply_next_idx,
      reply_last_idx, cand_last_idx, cand_last_term, cand_machine_version,
      host_term_idx, host_term_val, token;
};

// A group's P-wide input rows in registers (P > 0; the runtime-width
// instance reads them where it uses them).
template <int P>
struct Rows {
  static constexpr int A = P > 0 ? P : 1;
  uint8_t voting[A], active[A], votes[A], pre_votes[A];
  int32_t match[A], next[A];
};

// What a thread reads for its row of a tile that does not depend on the
// maps, so that for a block's first tile it is read before the grid
// barrier, beside phase A: a step column's rows, mailbox column and
// group; a pass-through thread's group.
template <int P>
struct Pre {
  int src, dst;
  Mail m;
  Group gr;
  Rows<P> rows;
};

template <int P>
__device__ __forceinline__ Pre<P> prologue(const Args& a, const Tile& t) {
  Pre<P> pre;
  const int tid = threadIdx.x;
  pre.src = pre.dst = -1;
  if (tid >= t.n) return pre;
  if (t.step) {
    const int j = t.first + tid;
    column_rows(a, j, pre.src, pre.dst);
    const size_t S = a.s;
    const int32_t* col = a.packed + j;
    Mail& m = pre.m;
    m.msg_type = col[M_MSG_TYPE * S];
    m.sender = col[M_SENDER_SLOT * S];
    m.mterm = col[M_TERM * S];
    m.prev_idx = col[M_PREV_IDX * S];
    m.prev_term = col[M_PREV_TERM * S];
    m.num_entries = col[M_NUM_ENTRIES * S];
    m.entries_last_term = col[M_ENTRIES_LAST_TERM * S];
    m.leader_commit = col[M_LEADER_COMMIT * S];
    m.success = col[M_SUCCESS * S];
    m.reply_next_idx = col[M_REPLY_NEXT_IDX * S];
    m.reply_last_idx = col[M_REPLY_LAST_IDX * S];
    m.cand_last_idx = col[M_CAND_LAST_IDX * S];
    m.cand_last_term = col[M_CAND_LAST_TERM * S];
    m.cand_machine_version = col[M_CAND_MACHINE_VERSION * S];
    m.host_term_idx = col[M_HOST_TERM_IDX * S];
    m.host_term_val = col[M_HOST_TERM_VAL * S];
    m.token = col[M_TOKEN * S];
  } else {
    pre.src = t.first + tid;  // dst: the group unless a column owns it
  }
  pre.gr = load_scalars(a, pre.src);
  if constexpr (P > 0) {
    const size_t rp = static_cast<size_t>(pre.src) * P;
    const StateIn& in = a.in;
#pragma unroll
    for (int s = 0; s < P; ++s) {
      pre.rows.voting[s] = in.voting[rp + s];
      pre.rows.active[s] = in.active[rp + s];
      pre.rows.votes[s] = in.votes[rp + s];
      pre.rows.pre_votes[s] = in.pre_votes[rp + s];
      pre.rows.match[s] = in.match_index[rp + s];
      pre.rows.next[s] = in.next_index[rp + s];
    }
  }
  return pre;
}

// Sub-phase 2 of a step tile: column first + tid, from its prologue.
// dst_row[tid] gets the row it writes back (or -1).
template <int P>
__device__ __forceinline__ void step_column(const Args& a, const Tile& t,
                                            const Pre<P>& pre, int32_t* tile,
                                            int32_t* dst_row, uint64_t* bar,
                                            uint32_t parity) {
  const int tid = threadIdx.x;
  if (tid >= t.n) {
    bar_wait(bar, parity);
    return;
  }
  const int j = t.first + tid;
  const int k = a.k, p = a.p;
  const StateIn& in = a.in;
  const StateOut& out = a.out;
  const int src = pre.src, dst = pre.dst;
  const size_t S = a.s;
  const Mail& m = pre.m;
  const int32_t msg_type = m.msg_type;
  const int32_t sender = m.sender;
  const int32_t mterm = m.mterm;
  const int32_t prev_idx = m.prev_idx;
  const int32_t prev_term = m.prev_term;
  const int32_t num_entries = m.num_entries;
  const int32_t entries_last_term = m.entries_last_term;
  const int32_t leader_commit = m.leader_commit;
  const bool success = m.success != 0;
  const int32_t reply_next_idx = m.reply_next_idx;
  const int32_t reply_last_idx = m.reply_last_idx;
  const int32_t cand_last_idx = m.cand_last_idx;
  const int32_t cand_last_term = m.cand_last_term;
  const int32_t cand_machine_version = m.cand_machine_version;
  const int32_t host_term_idx = m.host_term_idx;
  const int32_t host_term_val = m.host_term_val;
  const int32_t token = m.token;

  Group gr = pre.gr;
  apply_maps(a, gr, src);
  bar_wait(bar, parity);  // the tile has arrived
  dst_row[tid] = dst;
  lay_run(gr, tile + tid * k, k);

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
          gr.unknown_lo, gr.unknown_hi, gr.ring[floor_mod(prev_idx, k)], k,
          &local_prev_term, &prev_known);
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
  const Rows<P>& rows = pre.rows;
  // entry s of an input row: from registers (P > 0) or device memory
  auto row_at = [&](const uint8_t* regs, const uint8_t* mem, int s) {
    if constexpr (P > 0) {
      return regs[s] != 0;
    } else {
      return mem[rp + s] != 0;
    }
  };
  auto member_at = [&](int s) {
    return row_at(rows.voting, in.voting, s) && row_at(rows.active, in.active, s);
  };
  auto vote_at = [&](int s) {
    return ((count_vote && s == sender) || row_at(rows.votes, in.votes, s)) &&
           role1 == R_CANDIDATE;
  };
  auto pre_vote_at = [&](int s) {
    return ((count_prevote && s == sender) ||
            row_at(rows.pre_votes, in.pre_votes, s)) &&
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
    int32_t match_in, next_in;
    if constexpr (P > 0) {
      match_in = rows.match[s];
      next_in = rows.next[s];
    } else {
      match_in = in.match_index[rp + s];
      next_in = in.next_index[rp + s];
    }
    const int32_t match2 = became_leader ? 0 : match_in;
    const int32_t next2 = became_leader ? wadd(last_index2, 1) : next_in;
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
    agreed = quorum_pick_local<P>(eff, n_voters);
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
                                  : gr.ring[agreed_slot];
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
  int32_t* e = a.egress + j;
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

  // an accepted batch changes only the tail slot of the scattered ring
  // (a pad column's row is dropped on write-back)
  if (takes_entries) gr.ring[tail_slot] = entries_last_term;
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
}

// Sub-phase 2 of a pass-through chunk (active set): group first + tid,
// unless a real column writes it, gets its scattered scalars and P-wide
// rows (its ring row goes in write_back). dst_row[tid] gets the group,
// or -1 where a column writes it.
template <int P>
__device__ __forceinline__ void pass_group(const Args& a, const Tile& t,
                                           const Pre<P>& pre, int32_t* tile,
                                           int32_t* dst_row, uint64_t* bar,
                                           uint32_t parity) {
  const int tid = threadIdx.x;
  const int r = pre.src;
  Group gr = pre.gr;
  bool mine = false;
  if (tid < t.n) {  // the owner tag and the maps, read together
    apply_maps(a, gr, r);
    mine = !owned(a, r);
  }
  bar_wait(bar, parity);
  if (tid >= t.n) return;
  dst_row[tid] = mine ? r : -1;
  if (!mine) return;
  lay_run(gr, tile + tid * a.k, a.k);
  const StateIn& in = a.in;
  const StateOut& out = a.out;
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
  const int np = P > 0 ? P : a.p;
  const size_t rp = static_cast<size_t>(r) * np;
  if constexpr (P > 0) {
#pragma unroll
    for (int s = 0; s < P; ++s) {
      out.match_index[rp + s] = pre.rows.match[s];
      out.next_index[rp + s] = pre.rows.next[s];
      out.votes[rp + s] = pre.rows.votes[s];
      out.pre_votes[rp + s] = pre.rows.pre_votes[s];
    }
  } else {
    for (int s = 0; s < np; ++s) {
      out.match_index[rp + s] = in.match_index[rp + s];
      out.next_index[rp + s] = in.next_index[rp + s];
      out.votes[rp + s] = in.votes[rp + s];
      out.pre_votes[rp + s] = in.pre_votes[rp + s];
    }
  }
}

// Tile row r (w elements of T) to row dst_row[r] of `to`, or nowhere if
// that is -1; coalesced, element i of the tile is element c of row r,
// both stepping by blockDim.x.
template <class T>
__device__ __forceinline__ void copy_rows(T* to, const T* from,
                                          const int32_t* dst_row, int n,
                                          int w) {
  const int tid = threadIdx.x;
  const int dr = blockDim.x / w, dc = blockDim.x - dr * w;
  int r = tid / w, c = tid - r * w;
  for (int i = tid; i < n * w; i += blockDim.x) {
    const int d = dst_row[r];
    if (d >= 0) to[static_cast<size_t>(d) * w + c] = from[i];
    r += dr;
    c += dc;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
}

// Sub-phase 3: the tile's rows to the output ring, 16 bytes a store where
// the rows are (K a multiple of 4, the ring 16-byte aligned).
__device__ __forceinline__ void write_back(const Args& a, const Tile& t,
                                           const int32_t* tile,
                                           const int32_t* dst_row) {
  int32_t* ring = a.out.term_suffix;
  if (a.k % 4 == 0 && aligned16(ring)) {
    copy_rows(reinterpret_cast<int4*>(ring),
              reinterpret_cast<const int4*>(tile), dst_row, t.n, a.k / 4);
  } else {
    copy_rows(ring, tile, dst_row, t.n, a.k);
  }
}

// The step: one cooperative launch, phase A, the grid barrier, phase B
// (the file's head says what each does). A block stages its first tile
// and reads its prologue before the barrier, beside phase A.
template <int P>
__global__ void __launch_bounds__(kThreads) step_kernel(const Args a) {
  extern __shared__ __align__(16) int32_t tile[];  // kThreads * K
  __shared__ __align__(8) uint64_t bar;
  __shared__ int32_t dst_row[kThreads];
  if (threadIdx.x == 0) bar_init(&bar, blockDim.x);
  block_sync();
  const int first = blockIdx.x;
  Pre<P> pre;
  if (first < a.items) {
    const Tile t = tile_of(a, first);
    stage_tile(a, t, tile, &bar);
    pre = prologue<P>(a, t);
  }
  scatter_index(a);
  grid_sync();  // the maps are complete
  uint32_t parity = 0;
  for (int item = first; item < a.items; item += gridDim.x) {
    const Tile t = tile_of(a, item);
    if (item != first) {
      stage_tile(a, t, tile, &bar);
      pre = prologue<P>(a, t);
    }
    if (t.step) {
      step_column<P>(a, t, pre, tile, dst_row, &bar, parity);
    } else {
      pass_group<P>(a, t, pre, tile, dst_row, &bar, parity);
    }
    block_sync();
    write_back(a, t, tile, dst_row);
    block_sync();  // the tile and dst_row are free for the next item
    parity ^= 1;
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

// The one output buffer (ops/step.py out_layout builds the same views):
// the ring [G, K] at 0, the ten [G] scalars, match_index and next_index
// [G, P], the egress (17, S), all int32, then votes and pre_votes [G, P]
// bool. The ring starts the buffer so that its rows, the next step's
// input, keep the buffer's alignment.
constexpr int kNumOut = 16;  // OUT_FIELDS, then the egress
void out_offsets(int g, int p, int k, int s, long long* off) {
  const long long G = g, GP = static_cast<long long>(g) * p;
  const long long sc = 4 * G * k;          // the ten [G] scalars
  const long long peer = sc + 4 * 10 * G;  // match_index, next_index
  const long long eg = peer + 4 * 2 * GP;  // the egress
  const long long bools = eg + 4 * 17 * static_cast<long long>(s);
  const long long at[kNumOut] = {
      sc, sc + 4 * G, sc + 8 * G, sc + 12 * G,            // current_term ..
      sc + 16 * G, sc + 20 * G, sc + 24 * G, sc + 28 * G,  // .. leader_slot
      peer, peer + 4 * GP,                                 // match, next
      bools, bools + GP,                                   // votes, pre_votes
      0,                                                   // term_suffix
      sc + 32 * G, sc + 36 * G,  // unknown_lo, unknown_hi
      eg};
  for (int f = 0; f < kNumOut; ++f) off[f] = at[f];
}

// Fill the kernel's arguments; next_in (if not null) gets the 23 field
// pointers of the state the step returns: its outputs where it changes a
// field, the input's elsewhere.
Args make_args(const void* const* in_ptrs, void** next_in, void* out_v,
               const void* packed, const void* gidx, void* scratch,
               uint32_t epoch, int g, int p, int k, int s) {
  long long off[kNumOut];
  out_offsets(g, p, k, s, off);
  char* base = static_cast<char*>(out_v);
  void* outs[kNumOut];
  for (int f = 0; f < kNumOut; ++f) outs[f] = base + off[f];
  Args a;
  a.in = state_in(in_ptrs);
  a.out = state_out(outs);
  a.packed = static_cast<const int32_t*>(packed);
  a.gidx = static_cast<const int32_t*>(gidx);
  a.egress = static_cast<int32_t*>(outs[kNumOut - 1]);
  a.run_map = static_cast<unsigned long long*>(scratch);
  a.wmax_map = a.run_map + g;
  a.owner = reinterpret_cast<uint32_t*>(a.wmax_map + g);
  a.epoch = epoch;
  a.g = g;
  a.p = p;
  a.k = k;
  a.s = s;
  a.col_tiles = (s + kThreads - 1) / kThreads;
  a.items = a.col_tiles + (gidx != nullptr ? (g + kThreads - 1) / kThreads : 0);
  if (next_in != nullptr) {
    // the state field each output replaces (ops/step.py OUT_FIELDS)
    const int field_of[kNumOut - 1] = {0, 1, 2, 4, 5, 6, 9, 10, 13, 14,
                                       17, 18, 19, 20, 21};
    for (int f = 0; f < 23; ++f) next_in[f] = const_cast<void*>(in_ptrs[f]);
    for (int f = 0; f < kNumOut - 1; ++f) next_in[field_of[f]] = outs[f];
  }
  return a;
}

// ---- host launchers (nvcc only): everything above is plain C++ apart
// from the CUDA keywords and the helpers of step_async.cuh, and
// tests/test_torch_step_host.py compiles it with a host compiler behind
// a small shim to run the kernel's phases on the CPU.

}  // namespace

#include <map>
#include <mutex>
#include <tuple>

namespace {

// the most blocks of step_kernel<P> the card holds at once with `smem`
// bytes of tile, found once per (device, P, smem) with the occupancy API
// (a cooperative launch must not exceed it)
cudaError_t coresident_blocks(const void* fn, int P, size_t smem, int dev,
                              int* most) {
  static std::mutex lock;
  static std::map<std::tuple<int, int, size_t>, int> known;
  std::lock_guard<std::mutex> hold(lock);
  const auto key = std::make_tuple(dev, P, smem);
  const auto it = known.find(key);
  if (it != known.end()) {
    *most = it->second;
    return cudaSuccess;
  }
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                        smem);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  *most = known[key] = per_sm * sms;
  return cudaSuccess;
}

template <int P>
cudaError_t launch_step(Args& a, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(&step_kernel<P>);
  const size_t smem = sizeof(int32_t) * kThreads * static_cast<size_t>(a.k);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int most = 0;
  err = coresident_blocks(fn, P, smem, dev, &most);
  if (err != cudaSuccess) return err;
  if (most == 0) return cudaErrorCooperativeLaunchTooLarge;
  const dim3 grid(a.items < most ? a.items : most);
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(fn, grid, dim3(kThreads), args, smem,
                                     stream);
}

int launch_all(const void* const* in, void** next_in, void* out,
               const void* packed, const void* gidx, void* scratch,
               unsigned epoch, int g, int p, int k, int s,
               cudaStream_t stream) {
  if (g <= 0 || k <= 0 || s <= 0 || p < 1 || epoch == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = make_args(in, next_in, out, packed, gidx, scratch, epoch, g, p,
                     k, s);
  cudaError_t err;
  switch (p) {
    case 1: err = launch_step<1>(a, stream); break;
    case 2: err = launch_step<2>(a, stream); break;
    case 3: err = launch_step<3>(a, stream); break;
    case 4: err = launch_step<4>(a, stream); break;
    case 5: err = launch_step<5>(a, stream); break;
    case 6: err = launch_step<6>(a, stream); break;
    case 7: err = launch_step<7>(a, stream); break;
    case 8: err = launch_step<8>(a, stream); break;
    default: err = launch_step<0>(a, stream); break;
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the refused launch's error
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entry points launch on `stream`, synchronise nothing and allocate
// nothing. in: the 23 GroupState field pointers in field order; next_in:
// 23 pointers the launcher fills with the returned state's fields (or
// null); out: the one output buffer (out_offsets); scratch: the
// persistent maps, 20*g bytes, zeroed when first allocated; epoch: not 0,
// and greater than that of every earlier launch on this scratch (or the
// scratch zeroed since). Return the launch's CUDA error (0 on success; a
// refused launch returns its error and runs nothing).

// full width: packed is (24, g), S = g
extern "C" int ra_step_full_launch(const void* const* in, void** next_in,
                                   void* out, const void* packed,
                                   void* scratch, unsigned epoch, int g,
                                   int p, int k, void* stream) {
  return launch_all(in, next_in, out, packed, nullptr, scratch, epoch, g, p,
                    k, g, static_cast<cudaStream_t>(stream));
}

// active set: packed is (24, s), gidx is (s,)
extern "C" int ra_step_sub_launch(const void* const* in, void** next_in,
                                  void* out, const void* packed,
                                  const void* gidx, void* scratch,
                                  unsigned epoch, int g, int p, int k, int s,
                                  void* stream) {
  if (gidx == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_all(in, next_in, out, packed, gidx, scratch, epoch, g, p, k,
                    s, static_cast<cudaStream_t>(stream));
}

// The host part of an active-set call alone, for measuring it: it fills
// next_in as ra_step_sub_launch does and launches nothing.
extern "C" int ra_step_sub_host_only(const void* const* in, void** next_in,
                                     void* out, const void* packed,
                                     const void* gidx, void* scratch,
                                     unsigned epoch, int g, int p, int k,
                                     int s, void* stream) {
  (void)stream;
  make_args(in, next_in, out, packed, gidx, scratch, epoch, g, p, k, s);
  return 0;
}

// the same for a full-width call
extern "C" int ra_step_full_host_only(const void* const* in, void** next_in,
                                      void* out, const void* packed,
                                      void* scratch, unsigned epoch, int g,
                                      int p, int k, void* stream) {
  (void)stream;
  make_args(in, next_in, out, packed, nullptr, scratch, epoch, g, p, k, g);
  return 0;
}
