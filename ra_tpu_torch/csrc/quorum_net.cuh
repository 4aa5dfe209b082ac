// The quorum network shared by quorum.cu (the standalone scan) and step.cu
// (the scan inlined in the fused consensus step).
//
// quorum_pick<P>(m, nvoters) returns the (nvoters/2)-th largest entry of a
// voter-masked match vector held in registers: non-voters must already be
// -1 in m. The row is sorted ascending by an odd-even transposition
// network and ascending position clamp(P - 1 - floor(nvoters / 2), 0,
// P - 1) is picked, exactly as ra_tpu_torch.ops.quorum.agreed_commit_plain.
// m is sorted in place.
//
// quorum_pick_rank(eff, p, nvoters) is the same pick at a runtime width p,
// for groups wider than the register instances: eff(s) returns entry s.

#pragma once

#include <stdint.h>

template <int P>
__device__ __forceinline__ int32_t quorum_pick(int32_t (&m)[P],
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
  // ascending position clamp(P - 1 - floor(nvoters / 2), 0, P - 1);
  // '>>' on a signed int is an arithmetic shift, i.e. floor division
  const int pos = max(0, min(P - 1, P - 1 - (nvoters >> 1)));
  // The pick reads a small per-thread array at the runtime position.
  // A register select chain, r = (s == pos) ? m[s] : r over s, came out
  // wrong at -O3 with nvcc 12.8 for sm_90a (it returned m[P-1] while the
  // same source at -O0 -G and a host build gave m[pos]); the indexed
  // read costs P local stores and one load.
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
