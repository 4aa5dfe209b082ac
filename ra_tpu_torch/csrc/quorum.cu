// Quorum scan: the agreed commit index of every raft group.
//
// Replaces the Pallas TPU kernel ra_tpu/ops/pallas_quorum.py::_quorum_kernel
// (reached through agreed_commit_pallas). For each group it returns the
// (nvoters/2)-th largest entry of the voter-masked match vector: non-voters
// count as -1, the row is sorted ascending by an odd-even transposition
// network, and ascending position clamp(P - 1 - floor(nvoters / 2), 0, P - 1)
// is picked. This is exactly ra_tpu_torch.ops.quorum.agreed_commit_plain.
//
// Design: one thread per group over the row-major [G, P] inputs as they are
// (the TPU kernel's transpose to peers-on-sublanes and its 128-lane padding
// are not needed). Each thread holds its P values in registers; P is a
// template parameter (1..8), so the network unrolls fully; only the final
// pick goes through a P-entry per-thread array. The last partial block is
// masked.
//
// Bound on an H100 SXM (3.35 TB/s): the kernel reads G*P int32 matches, G*P
// bool bytes and G int32 voter counts and writes G int32 results, G*(5P+8)
// bytes in all: 235,520 bytes at G=10240, P=3, or about 0.07 us. Its
// operations (a few dozen integer ops a group) are far below the card's
// rate. At the main path's sizes the kernel is bound by launch latency,
// and this design does nothing about that bound yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int P>
__global__ void quorum_kernel(const int32_t* __restrict__ match,
                              const uint8_t* __restrict__ voting,
                              const int32_t* __restrict__ nvoters,
                              int32_t* __restrict__ out, int g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g) return;
  const size_t row = static_cast<size_t>(i) * P;
  int32_t m[P];
#pragma unroll
  for (int s = 0; s < P; ++s) m[s] = voting[row + s] ? match[row + s] : -1;
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
  const int pos = max(0, min(P - 1, P - 1 - (nvoters[i] >> 1)));
  // The pick reads a small per-thread array at the runtime position.
  // A register select chain, r = (s == pos) ? m[s] : r over s, came out
  // wrong at -O3 with nvcc 12.8 for sm_90a (it returned m[P-1] while the
  // same source at -O0 -G and a host build gave m[pos]); the indexed
  // read costs P local stores and one load, nothing next to the launch.
  int32_t sorted[P];
#pragma unroll
  for (int s = 0; s < P; ++s) sorted[s] = m[s];
  out[i] = sorted[pos];
}

template <int P>
void launch(const void* match, const void* voting, const void* nvoters,
            void* out, int g, cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (g + threads - 1) / threads;
  quorum_kernel<P><<<blocks, threads, 0, stream>>>(
      static_cast<const int32_t*>(match), static_cast<const uint8_t*>(voting),
      static_cast<const int32_t*>(nvoters), static_cast<int32_t*>(out), g);
}

}  // namespace

// Launch on `stream`; no synchronisation, no allocation. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ra_quorum_launch(const void* match, const void* voting,
                                const void* nvoters, void* out, int g, int p,
                                void* stream) {
  if (g <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: launch<1>(match, voting, nvoters, out, g, s); break;
    case 2: launch<2>(match, voting, nvoters, out, g, s); break;
    case 3: launch<3>(match, voting, nvoters, out, g, s); break;
    case 4: launch<4>(match, voting, nvoters, out, g, s); break;
    case 5: launch<5>(match, voting, nvoters, out, g, s); break;
    case 6: launch<6>(match, voting, nvoters, out, g, s); break;
    case 7: launch<7>(match, voting, nvoters, out, g, s); break;
    case 8: launch<8>(match, voting, nvoters, out, g, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
