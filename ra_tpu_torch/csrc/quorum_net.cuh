// The quorum picks shared by quorum.cu (the standalone scan) and step.cu
// (the scan inlined in the fused consensus step).
//
// Each returns the (nvoters/2)-th largest entry of a voter-masked match
// vector held in registers (non-voters must already be -1 in m): the entry
// at ascending position pos = clamp(P - 1 - floor(nvoters / 2), 0, P - 1)
// of the sorted row, exactly as ra_tpu_torch.ops.quorum.agreed_commit_plain
// picks it.
//
// quorum_pick<P>(m, nvoters), quorum.cu's, finds the entry by rank instead
// of by sorting: the entry v at position pos is the one with
// #{entries < v} <= pos < #{entries <= v}. With ties several entries pass
// the test, all of one value; a masked max over the passing entries
// returns it. P*P independent compares, no data-dependent index, m is not
// written. Its SASS in quorum.cu holds no STL/LDL and ptxas reports 0
// bytes of stack and no spills at P = 1..8 (chip_smoke.py checks the SASS
// at every build).
//
// quorum_pick_local<P>(m, nvoters), step.cu's, sorts m in place with an
// odd-even transposition network (P dependent passes) and reads the
// sorted row at the runtime position through a per-thread array in local
// memory (P stores and one load). A register select chain over the sorted
// row, r = (s == pos) ? m[s] : r, came out wrong at -O3 with nvcc 12.8 for
// sm_90a (it returned m[P-1] where a lower position was asked), hence the
// array. The card tests pin that case for quorum_pick (every P = 3..8,
// the largest entry last, a lower position asked). step.cu keeps this
// pick: with the rank form inlined, its full-width step measured 6.185 and
// 6.219 us of card time against 6.178 and 6.179 us with this pick, in
// turns on one H100 (PERF.md section 6); one thread's dependent chain a
// group bounds that kernel, and the rank form's P*P compares lengthen it.
//
// quorum_pick_rank(eff, p, nvoters) is the same pick at a runtime width p,
// for groups wider than the register instances: eff(s) returns entry s.

#pragma once

#include <stdint.h>

template <int P>
__device__ __forceinline__ int32_t quorum_pick(const int32_t (&m)[P],
                                               int32_t nvoters) {
  // '>>' on a signed int is an arithmetic shift, i.e. floor division
  const int pos = max(0, min(P - 1, P - 1 - (nvoters >> 1)));
  int32_t r = INT32_MIN;
#pragma unroll
  for (int s = 0; s < P; ++s) {
    int lt = 0, le = 0;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      lt += m[j] < m[s];
      le += m[j] <= m[s];
    }
    r = max(r, (lt <= pos && pos < le) ? m[s] : INT32_MIN);
  }
  return r;
}

template <int P>
__device__ __forceinline__ int32_t quorum_pick_local(int32_t (&m)[P],
                                                     int32_t nvoters) {
  // odd-even transposition sort, ascending: P passes sort P values.
  // Every pass walks all adjacent pairs and keeps those of its parity;
  // the bounds are compile-time constants, so the loops unroll fully and
  // the parity test folds away.
#pragma unroll
  for (int pass = 0; pass < P; ++pass) {
#pragma unroll
    for (int s = 0; s + 1 < P; ++s) {
      if ((s & 1) == (pass & 1)) {
        const int32_t lo = min(m[s], m[s + 1]);
        const int32_t hi = max(m[s], m[s + 1]);
        m[s] = lo;
        m[s + 1] = hi;
      }
    }
  }
  const int pos = max(0, min(P - 1, P - 1 - (nvoters >> 1)));
  int32_t sorted[P];
#pragma unroll
  for (int s = 0; s < P; ++s) sorted[s] = m[s];
  return sorted[pos];
}

// The entry at ascending position pos of the sorted row is the value v
// for which #{entries < v} <= pos < #{entries <= v}; each entry is tried
// as v in turn, p*p calls of eff in all and no per-thread array.
template <class Eff>
__device__ __forceinline__ int32_t quorum_pick_rank(const Eff& eff, int p,
                                                    int32_t nvoters) {
  const int pos = max(0, min(p - 1, p - 1 - (nvoters >> 1)));
  for (int i = 0; i < p; ++i) {
    const int32_t v = eff(i);
    int lt = 0, le = 0;
    for (int j = 0; j < p; ++j) {
      const int32_t w = eff(j);
      lt += w < v;
      le += w <= v;
    }
    if (lt <= pos && pos < le) return v;
  }
  return -1;  // not reached for p >= 1: some entry holds position pos
}
